"""EPS and PostScript output as Pillow 12.1's EpsImagePlugin._save writes
it (the JAX package's writer goes through Pillow): a grey or RGB image
as hex samples under an `image` or `false 3 colorimage` operator. Pillow
reads EPS only through Ghostscript, so the port has no EPS decoder;
`hex_payload` parses a file's samples back for the checks.
"""

from __future__ import annotations

import numpy as np

_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)
LINE_BYTES = 79 // 2  # EpsEncode.c: a newline after every 39 samples


def encode_eps(img: np.ndarray) -> bytes:
    """[H, W] grey or [H, W, 3] RGB uint8 -> Pillow's EPS bytes: the DSC
    header with the bounding box, the image operator, the samples as
    lower-case hex, 39 to a line, then %%%%EndBinary. RGBA raises
    ValueError, as Pillow does."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] != 3:
        raise ValueError("image mode is not supported")
    h, w = img.shape[:2]
    bands, op = (1, b"image") if img.ndim == 2 else (3, b"false 3 colorimage")
    head = (b"%!PS-Adobe-3.0 EPSF-3.0\n%%Creator: PIL 0.1 EpsEncode\n"
            + b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h) + b"%%Pages: 1\n%%EndComments\n"
            + b"%%Page: 1 1\n" + b"%%ImageData: %d %d " % (w, h)
            + b'%d %d 0 1 1 "%s"\n' % (8, bands, op)
            + b"gsave\n10 dict begin\n" + b"/buf %d string def\n" % (w * bands)
            + b"%d %d scale\n" % (w, h) + b"%d %d 8\n" % (w, h)
            + b"[%d 0 0 -%d 0 %d]\n" % (w, h, h)
            + b"{ currentfile buf readhexstring pop } bind\n" + op + b"\n")
    # Pillow writes the trailer's "%%%%" as it stands (no % formatting)
    return head + hex_lines(img.ravel()) + b"\n%%%%EndBinary\ngrestore end\n"


def hex_lines(samples: np.ndarray) -> bytes:
    """Samples as hex digit pairs, a newline after every LINE_BYTES."""
    digits = np.stack([_HEX[samples >> 4], _HEX[samples & 15]], axis=-1).reshape(-1)
    n = samples.size
    full = n // LINE_BYTES
    body = digits[:full * LINE_BYTES * 2].reshape(full, LINE_BYTES * 2)
    lines = np.concatenate([body, np.full((full, 1), ord("\n"), np.uint8)], axis=1).tobytes()
    rest = digits[full * LINE_BYTES * 2:].tobytes()
    if rest or not lines:
        return lines + rest
    return lines[:-1]  # no newline after the last sample


def hex_payload(data: bytes) -> np.ndarray:
    """The samples of an EPS file from encode_eps, as [H, W] or [H, W, 3]."""
    head, _, rest = data.partition(b"{ currentfile buf readhexstring pop } bind\n")
    op, _, rest = rest.partition(b"\n")
    body = rest[:rest.rindex(b"\n%%%%EndBinary\n")]
    w, h = (int(v) for v in head.split(b"%%BoundingBox: 0 0 ")[1].split(b"\n")[0].split())
    samples = np.frombuffer(bytes.fromhex(body.replace(b"\n", b"").decode("ascii")), np.uint8)
    return samples.reshape(h, w) if op == b"image" else samples.reshape(h, w, 3)
