"""The port's OpenEXR and Radiance HDR codecs against the JAX package's.

The bytes come from the JAX package's encoders (half and float EXR, RGB
and RGBA; flat RGBE) and from test encoders here for what those never
write: EXR of NONE, RLE and ZIPS compression, UINT and luminance
channels, and new-style run-length HDR scanlines. Each decodes to the same
array in the port (gatling_tpu_torch.imgio.load_image) and in
gatling_tpu.imgio.load_image, bit for bit; the port's encoders write the
JAX package's bytes, which decode back identically in both.
"""

import struct
import zlib

import numpy as np
import pytest

from gatling_tpu import imgio as jimgio
from gatling_tpu.imgio import exr as jexr
from gatling_tpu.imgio import hdr as jhdr

from gatling_tpu_torch import imgio as timgio
from gatling_tpu_torch.imgio import exr as texr
from gatling_tpu_torch.imgio import hdr as thdr


def _hdr_image(seed: int, h: int, w: int, c: int) -> np.ndarray:
    """Floats over six decades, some zeros and some above 1: an HDR image."""
    rng = np.random.default_rng(seed)
    img = (10.0 ** rng.uniform(-3.0, 3.0, (h, w, c))).astype(np.float32)
    img[rng.random((h, w)) < 0.05] = 0.0
    return img


def _same_decode(data: bytes) -> np.ndarray:
    """Decode in both packages; the arrays agree bit for bit."""
    ref = jimgio.load_image(data).data
    got = timgio.load_image(data)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    return got


@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("channels", [3, 4])
def test_exr_from_the_jax_encoder(half, channels):
    img = _hdr_image(channels + 2 * half, 37, 23, channels)  # 37 rows: a short last ZIP block
    data = jexr.encode_exr(img, half=half)
    got = _same_decode(data)
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(got[..., :channels], want)
    if channels == 3:
        assert (got[..., 3] == 1.0).all()
    assert texr.encode_exr(img, half=half) == data  # the port writes the same bytes


def test_hdr_from_the_jax_encoder():
    img = _hdr_image(9, 19, 31, 3)
    data = jhdr.encode_hdr(img)
    got = _same_decode(data)
    assert (got[..., 3] == 1.0).all()
    # RGBE keeps 8 bits of mantissa for the largest channel of a pixel
    big = img.max(-1, keepdims=True)
    assert (np.abs(got[..., :3] - img) <= big / 128.0 + 1e-30).all()
    assert thdr.encode_hdr(img) == data


def _exr(planes: dict[str, np.ndarray], ptype: int, compression: int) -> bytes:
    """A single-part scanline EXR of `planes` (name -> [H, W]) with pixel
    type ptype (0 UINT, 1 HALF, 2 FLOAT) and compression 0 NONE, 1 RLE,
    2 ZIPS or 3 ZIP: a test encoder, byte layout as the OpenEXR spec."""
    names = sorted(planes)
    h, w = planes[names[0]].shape
    dt = {0: "<u4", 1: "<f2", 2: "<f4"}[ptype]

    def attr(name, typ, payload):
        return name + b"\0" + typ + b"\0" + struct.pack("<i", len(payload)) + payload

    chlist = b"".join(n.encode() + b"\0" + struct.pack("<i4xii", ptype, 1, 1) for n in names)
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join([attr(b"channels", b"chlist", chlist + b"\0"),
                       attr(b"compression", b"compression", bytes([compression])),
                       attr(b"dataWindow", b"box2i", box),
                       attr(b"displayWindow", b"box2i", box),
                       attr(b"lineOrder", b"lineOrder", b"\0")]) + b"\0"
    lines = 16 if compression == 3 else 1
    chunks = []
    for y0 in range(0, h, lines):
        raw = b"".join(planes[n][y].astype(dt).tobytes()
                       for y in range(y0, min(y0 + lines, h)) for n in names)
        if compression:
            pred = jexr._predict_and_deinterleave(raw)
            comp = _rle(pred) if compression == 1 else zlib.compress(pred)
            raw = comp if len(comp) < len(raw) else raw
        chunks.append(struct.pack("<ii", y0, len(raw)) + raw)
    prefix = struct.pack("<iI", 20000630, 2) + header
    pos = len(prefix) + 8 * len(chunks)
    offsets = []
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    return prefix + struct.pack(f"<{len(chunks)}Q", *offsets) + b"".join(chunks)


def _rle(data: bytes) -> bytes:
    """OpenEXR's RLE: runs of 3 to 128 equal bytes as (count - 1, byte),
    literal stretches of up to 128 bytes as (-count, bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += struct.pack("<b", j - i) + data[i:i + 1]
            i = j + 1
            continue
        k = i
        while k < n and k - i < 128 and not (k + 2 < n and data[k] == data[k + 1] == data[k + 2]):
            k += 1
        out += struct.pack("<b", -(k - i)) + data[i:k]
        i = k
    return bytes(out)


@pytest.mark.parametrize("compression", [0, 1, 2, 3])
@pytest.mark.parametrize("ptype", [1, 2])
def test_exr_compressions(compression, ptype):
    """NONE, RLE (with runs: flat areas), ZIPS and ZIP of RGBA planes."""
    img = _hdr_image(10 * compression + ptype, 21, 40, 4)
    img[5:12, :] = 2.5  # long runs for the RLE
    data = _exr({c: img[..., k] for k, c in enumerate("RGBA")}, ptype, compression)
    assert data[:4] == timgio.EXR_MAGIC
    got = _same_decode(data)
    want = img.astype(np.float16).astype(np.float32) if ptype == 1 else img
    np.testing.assert_array_equal(got, want)


def test_exr_uint_and_luminance_channels():
    """A UINT RGB image, and a luminance (Y) image spread to grey."""
    rng = np.random.default_rng(12)
    u = rng.integers(0, 70000, (9, 14, 3)).astype(np.uint32)
    got = _same_decode(_exr({c: u[..., k] for k, c in enumerate("RGB")}, 0, 3))
    np.testing.assert_array_equal(got[..., :3], u.astype(np.float32))
    y = _hdr_image(13, 9, 14, 1)[..., 0]
    got = _same_decode(_exr({"Y": y}, 2, 2))
    for k in range(3):
        np.testing.assert_array_equal(got[..., k], y)


def _rgbe_rle(rgbe: np.ndarray) -> bytes:
    """New-style run-length Radiance scanlines: per line 2 2 w_hi w_lo,
    then each of the four channels as runs (128 + n, byte) and literals
    (n, bytes)."""
    h, w, _ = rgbe.shape
    body = bytearray()
    for y in range(h):
        body += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            row = rgbe[y, :, c]
            x = 0
            while x < w:
                run = 1
                while x + run < w and row[x + run] == row[x] and run < 127:
                    run += 1
                if run >= 3:
                    body += bytes([128 + run, int(row[x])])
                    x += run
                    continue
                lit = 1
                while x + lit < w and lit < 128 and not (
                        x + lit + 2 < w and row[x + lit] == row[x + lit + 1] == row[x + lit + 2]):
                    lit += 1
                body += bytes([lit]) + row[x:x + lit].tobytes()
                x += lit
    return b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode() + bytes(body)


def test_hdr_run_length_scanlines():
    """A new-style run-length HDR (a sky gradient with a flat band: runs
    and literals) decodes as its flat twin does."""
    img = _hdr_image(14, 11, 45, 3)
    img[3:6] = (0.25, 0.5, 1.0)
    rgbe = jhdr._float_to_rgbe(img)
    rle = _rgbe_rle(rgbe)
    flat = jhdr.encode_hdr(img)
    assert len(rle) < len(flat)
    np.testing.assert_array_equal(_same_decode(rle), _same_decode(flat))


def test_port_encoders_read_back(tmp_path):
    """write_image_file's .exr and .hdr, and load_image's report of them:
    float32 RGBA, `is_hdr`; a PNG stays uint8 and reads /255."""
    img = _hdr_image(15, 12, 10, 4)
    for ext in (".exr", ".hdr"):
        path = tmp_path / f"a{ext}"
        timgio.write_image_file(path, img)
        got = timgio.load_image_file(path)
        np.testing.assert_array_equal(got, jimgio.load_image_file(path).data)
        assert timgio.is_hdr(got) and timgio.as_float_rgba(got) is not got
    np.testing.assert_array_equal(timgio.load_image_file(tmp_path / "a.exr"),
                                  img.astype(np.float16).astype(np.float32))
    png = np.random.default_rng(16).integers(0, 256, (5, 6, 4)).astype(np.uint8)
    timgio.write_image_file(tmp_path / "b.png", png)
    got = timgio.load_image_file(tmp_path / "b.png")
    assert not timgio.is_hdr(got)
    np.testing.assert_array_equal(timgio.as_float_rgba(got),
                                  jimgio.load_image_file(tmp_path / "b.png").as_float_rgba())
    with pytest.raises(ValueError):
        timgio.load_image(b"#?RADIANCE\n")  # a truncated header
    with pytest.raises(ValueError):  # a JPEG cut inside its first segment, as JAX raises
        timgio.load_image(b"\xff\xd8\xff\xe0 a JPEG")
    with pytest.raises(ValueError):
        jimgio.load_image(b"\xff\xd8\xff\xe0 a JPEG")
