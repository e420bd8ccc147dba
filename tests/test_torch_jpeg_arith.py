"""The port's JPEG decoder on the processes Pillow's saver does not write
(imgio/jpeg.py and the native gatling_jpeg_decode_arith_scan and
gatling_jpeg_decode_lossless), against the JAX package's imgio (Pillow
12.1 over libjpeg-turbo 3.1.3).

1. Arithmetic coding (SOF9 sequential, SOF10 progressive): Pillow's
   Huffman files (4:2:0, 4:4:4, grey, progressive, with and without
   restart intervals) re-coded by make_fixtures.jpeg_arith, a jcarith.c
   encoder, with libjpeg's default conditioning and with a DAC segment.
   Pillow's decode of each arithmetic file equals its decode of the
   Huffman source (the encoder wrote the same coefficients), and the
   port's equals both.
2. Lossless frames (SOF3): make_fixtures.jpeg_lossless over predictors
   1-7 and point transforms 0 and 2, grey and RGB (Adobe transform 0),
   with and without restart intervals. At Pt=0 Pillow decodes each file to
   its source exactly, at Pt=2 to the source's samples with their two low
   bits cleared; the port gives the same. An arithmetic-coded lossless
   frame (SOF11) is one libjpeg-turbo does not implement: ValueError in
   both.
3. Block smoothing (jdcoefct.c decompress_smooth_data): Pillow's
   progressive files with their AC refinement scans, or all their AC or
   refinement scans, cut out, at sizes down to one and two blocks wide,
   4:2:0, 4:2:2 and 4:4:4: the port is bit-equal to Pillow.
4. Damage: two bytes changed past the first scan header of a progressive
   file, of arithmetic sequential, progressive and restart-interval files
   and of a lossless one: the same array, or ValueError in both.
"""

import importlib.util
import io
import os

import numpy as np
import pytest
from PIL import Image

from gatling_tpu import imgio as jimgio

from gatling_tpu_torch import imgio

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_fixtures", os.path.join(HERE, "data", "imgio", "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)


def pillow_jpeg(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def contract(data: bytes) -> str:
    try:
        want = jimgio.load_image(data).data
    except ValueError:
        with pytest.raises(ValueError):
            imgio.load_image(data)
        return "rejected"
    got = imgio.load_image(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got != want).any(-1)
    assert not diff.any(), (int(diff.sum()), np.argwhere(diff)[:3].tolist())
    return "array"


TEX = mf.texture(48, 64, 3, 3)
HUFFMAN = {"420": {}, "444": {"subsampling": 0}, "grey": None, "progressive": {"progressive": True},
           "restart": {"restart_marker_blocks": 2},
           "progressive_restart": {"progressive": True, "restart_marker_blocks": 1},
           "odd_size": "odd"}


def huffman_source(kind: str) -> bytes:
    opts = HUFFMAN[kind]
    if opts is None:
        return pillow_jpeg(TEX[..., 0])
    if opts == "odd":
        return pillow_jpeg(mf.texture(37, 53, 3, 4))
    return pillow_jpeg(TEX, **opts)


@pytest.mark.parametrize("conditioning", ("default", "dac"))
@pytest.mark.parametrize("kind", sorted(HUFFMAN))
def test_arithmetic_file_decodes_as_pillow(kind, conditioning):
    source = huffman_source(kind)
    dac = {0: (2, 5, 3), 1: (1, 1, 9)} if conditioning == "dac" else None
    data = mf.jpeg_arith(source, dac)
    assert (b"\xff\xc9" in data) != (b"\xff\xca" in data)  # SOF9 or SOF10
    assert np.array_equal(pillow_rgb(data), pillow_rgb(source))
    assert contract(data) == "array"


@pytest.mark.parametrize("pt", (0, 2))
@pytest.mark.parametrize("channels", (1, 3))
def test_lossless_file_decodes_as_pillow(channels, pt):
    """Predictors 1-7, with a restart every 4 rows and without."""
    img = mf.texture(21, 29, 3, 3)
    img = img[..., 0] if channels == 1 else img
    for psv in range(1, 8):
        for rows in (0, 4):
            data = mf.jpeg_lossless(img, psv, pt, rows)
            want = jimgio.load_image(data).data
            exact = (img >> pt) << pt
            assert np.array_equal(want[..., :3] if channels == 3 else want[..., 0], exact)
            assert contract(data) == "array"


def test_arithmetic_lossless_is_refused():
    with pytest.raises(ValueError):
        jimgio.load_image(mf.jpeg_lossless(TEX, 1, arith=True))
    assert contract(mf.jpeg_lossless(TEX, 1, arith=True)) == "rejected"


CUTS = {"no_ac_refinement": lambda ss, se, ah, al: not (ss and ah),
        "dc_only": lambda ss, se, ah, al: ss == 0,
        "first_dc_only": lambda ss, se, ah, al: ss == 0 and ah == 0,
        "no_refinement": lambda ss, se, ah, al: ah == 0}


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_block_smoothing_as_libjpeg(cut):
    """Sizes from 1x1 block to 8x10, one and two blocks wide among them."""
    for (h, w) in ((48, 64), (37, 53), (8, 8), (16, 9), (64, 24), (40, 20)):
        for channels, opts in ((1, {}), (3, {}), (3, {"subsampling": 0}), (3, {"subsampling": 1})):
            img = mf.texture(h, w, channels, 5)
            src = pillow_jpeg(img[..., 0] if channels == 1 else img, progressive=True, **opts)
            assert contract(mf.jpeg_scans(src, CUTS[cut])) == "array", (h, w, channels, opts)


DAMAGED = {"progressive": lambda: pillow_jpeg(TEX, progressive=True),
           "arith_sequential": lambda: mf.jpeg_arith(pillow_jpeg(TEX)),
           "arith_progressive": lambda: mf.jpeg_arith(pillow_jpeg(TEX, progressive=True)),
           "arith_restart": lambda: mf.jpeg_arith(pillow_jpeg(TEX, restart_marker_blocks=3)),
           "lossless": lambda: mf.jpeg_lossless(TEX, 4, 0, 4)}


@pytest.mark.parametrize("kind", sorted(DAMAGED))
def test_damage_meets_the_contract(kind):
    """Seeds 0-39: two bytes changed past the first SOS marker."""
    data = DAMAGED[kind]()
    lo = data.find(b"\xff\xda") + 2
    seen = set()
    for seed in range(40):
        rng = np.random.default_rng(seed)
        b = bytearray(data)
        for _ in range(2):
            b[int(rng.integers(lo, len(b) - 2))] = int(rng.integers(0, 256))
        seen.add(contract(bytes(b)))
    assert "array" in seen
