"""The port's WebP decoder (imgio/webp.py, vp8.py, vp8l.py and the native
library's VP8 and VP8L loops) against the JAX package's imgio (Pillow 12.1
over libwebp 1.6.0), bit for bit.

1. Pillow's saver: lossy RGB and RGBA at quality 0, 50, 80 and 100 and
   every method 0-6, RGBA at alpha_quality 0, 50 and 100, lossless with
   and without `exact`, animations (RGBA frames that change a part of the
   canvas, so that later frames are smaller and offset; RGB frames without
   alpha; lossy, lossless and mixed), at 1x1, 1x17, 17x1, 33x31 and 64x64:
   every file decodes to the JAX package's array (dtype, shape, every
   value).
2. Hand-made files for what the saver does not write: raw ALPH chunks
   with each of the four filters, nonzero reserved ALPH bits, an unknown
   ALPH method or pre-processing, a VP8X without the alpha flag that
   carries ALPH, a VP8L whose alpha hint is 0 over pixels that are not
   opaque, a first ANMF smaller than the canvas and offset on it, reserved
   VP8X flags, an ALPH before a VP8L: the JAX array, or ValueError in
   both packages.
3. Damaged files: every saver's file cut short and with bytes changed
   anywhere, from a seed: the same array or ValueError in both.
4. The native array stages against their NumPy twins, bit for bit: the
   VP8 inverse transforms (libwebp's C and SSE2 code), the fancy
   upsampler with YUV -> RGB, the ALPH unfilters, the four VP8L inverse
   transforms.
5. What the saver reaches: the VP8 header fields and VP8L transforms its
   files use (the simple loop filter and 2-8 token partitions it never
   writes), and a .webp write raises NotImplementedError naming its ROADMAP
   item.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from gatling_tpu import imgio as jimgio

from gatling_tpu_torch import imgio
from gatling_tpu_torch.imgio import vp8, vp8l, webp

SIZES = ((1, 1), (1, 17), (17, 1), (33, 31), (64, 64))


def image(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """A smooth pattern with noise; alpha a mix of ramps and holes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w, 2)
    phase = rng.uniform(0, 6.3, channels)
    img = np.stack([0.5 + 0.4 * np.sin(7.0 * xx + 4.0 * yy * (k + 1) + phase[k])
                    for k in range(channels)], axis=-1) + rng.normal(0, 0.05, (h, w, channels))
    img = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
    if channels == 4:
        img[..., 3] = np.where(rng.random((h, w)) < 0.1, 0, img[..., 3])
    return img


def save(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def save_all(frames: list, **kw) -> bytes:
    buf = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(buf, "WEBP", save_all=True, append_images=ims[1:], duration=50, **kw)
    return buf.getvalue()


def contract(data: bytes) -> str:
    """'array' when both packages decode to the same array, 'rejected' when
    both raise ValueError; anything else fails."""
    try:
        want = jimgio.load_image(data).data
    except ValueError:
        with pytest.raises(ValueError):
            imgio.load_image(data)
        return "rejected"
    got = imgio.load_image(data)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), int((got != want).any(-1).sum())
    return "array"


# ---------------------------------------------------------------------------
# 1. Pillow's saver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [0, 50, 80, 100])
@pytest.mark.parametrize("channels", [3, 4])
def test_lossy_corpus(channels, quality):
    """Every method at every size: the JAX package's array."""
    for k, (h, w) in enumerate(SIZES):
        img = image(h, w, channels, 10 * quality + k)
        for method in range(7):
            assert contract(save(img, quality=quality, method=method)) == "array"


@pytest.mark.parametrize("alpha_quality", [0, 50, 100])
def test_alpha_quality(alpha_quality):
    """The ALPH chunk lossless (100) or level-reduced (below): the same
    array (libwebp's alpha dithering is off by default)."""
    for k, (h, w) in enumerate(SIZES):
        img = image(h, w, 4, 100 + k)
        for method in (0, 4, 6):
            assert contract(save(img, quality=60, alpha_quality=alpha_quality,
                                 method=method)) == "array"


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("channels", [3, 4])
def test_lossless_corpus(channels, exact):
    """Lossless at methods 0-6 and qualities 0-100 (the transforms, the
    colour cache and the meta codes the encoder picks: half noise, a
    quarter posterised, for the meta codes)."""
    for k, (h, w) in enumerate(SIZES):
        img = image(h, w, channels, 200 + k)
        for method in range(7):
            assert contract(save(img, lossless=True, exact=exact, method=method,
                                 quality=(0, 50, 100)[method % 3])) == "array"
    for n in (64, 96):
        for method in (0, 4, 6):
            assert contract(save(mixed(n, channels, n), lossless=True, exact=exact,
                                 method=method)) == "array"


def mixed(n: int, channels: int, seed: int) -> np.ndarray:
    """n x n: the left half noise, the top right posterised, the rest
    smooth (the encoder then splits its prefix codes by region)."""
    img = image(n, n, channels, seed)
    img[:, :n // 2] = np.random.default_rng(seed).integers(0, 256, (n, n // 2, channels))
    img[:n // 2, n // 2:] = (img[:n // 2, n // 2:] >> 5) << 5
    return img


ANIMATIONS = {
    "rgba_parts": ({}, 4),
    "rgb_frames": ({}, 3),
    "lossless": ({"lossless": True}, 4),
    "lossy_q20": ({"quality": 20}, 4),
    "mixed": ({"allow_mixed": True}, 4),
    "minimize": ({"minimize_size": True, "kmin": 1, "kmax": 2}, 4),
}


@pytest.mark.parametrize("name", sorted(ANIMATIONS))
def test_animations(name):
    """The first frame on its canvas; later frames change a part of it, so
    the encoder writes them smaller and offset (never blended into the
    first)."""
    kw, channels = ANIMATIONS[name]
    for h, w in ((1, 1), (33, 31), (40, 64)):
        base = image(h, w, channels, 300 + h)
        frames = [base]
        for k in range(1, 3):
            f = base.copy()
            f[h // 4:h // 2 + 1, w // 3:w // 3 + w // 4 + 1] = image(h, w, channels, 310 + k)[
                h // 4:h // 2 + 1, w // 3:w // 3 + w // 4 + 1]
            frames.append(f)
        assert contract(save_all(frames, **kw)) == "array"


# ---------------------------------------------------------------------------
# 2. hand-made files
# ---------------------------------------------------------------------------

def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def image_chunk(simple: bytes) -> bytes:
    """The VP8 or VP8L chunk of a simple-format file."""
    return simple[12:]


def anmf(x: int, y: int, w: int, h: int, *chunks: bytes) -> bytes:
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 50))
    return chunk(b"ANMF", head + b"\0" + b"".join(chunks))


def _hand_made() -> dict[str, tuple[bytes, str]]:
    """name -> (file, the outcome both packages give)."""
    rng = np.random.default_rng(7)
    w, h = 23, 19
    lossy = image_chunk(save(image(h, w, 3, 1), quality=70))
    alpha = rng.integers(0, 256, w * h, np.uint8).tobytes()
    out = {}
    for filt in range(4):
        for pre in (0, 1):
            head = bytes([filt << 2 | pre << 4])
            out[f"raw_alph_filter{filt}_pre{pre}"] = (
                riff(vp8x(0x10, w, h), chunk(b"ALPH", head + alpha), lossy), "array")
    out["alph_reserved_bits"] = (riff(vp8x(0x10, w, h), chunk(b"ALPH", b"\x40" + alpha), lossy),
                                 "rejected")
    out["alph_method2"] = (riff(vp8x(0x10, w, h), chunk(b"ALPH", b"\x02" + alpha), lossy),
                           "rejected")
    out["alph_preprocessing2"] = (riff(vp8x(0x10, w, h), chunk(b"ALPH", b"\x20" + alpha), lossy),
                                  "rejected")
    out["alph_short_raw"] = (riff(vp8x(0x10, w, h), chunk(b"ALPH", b"\x00" + alpha[:-1]), lossy),
                             "rejected")
    out["alph_without_alpha_flag"] = (
        riff(vp8x(0x00, w, h), chunk(b"ALPH", b"\x04" + alpha), lossy), "array")
    lossless = save(image(h, w, 4, 2), lossless=True)
    out["alph_before_vp8l"] = (
        riff(vp8x(0x10, w, h), chunk(b"ALPH", b"\x00" + alpha), image_chunk(lossless)),
        "rejected")
    hint0 = bytearray(lossless)
    assert hint0[24] & 0x10, "the saver sets the alpha hint of an RGBA image"
    hint0[24] &= ~0x10
    out["vp8l_alpha_hint_0"] = (bytes(hint0), "array")
    out["vp8x_reserved_flags"] = (riff(vp8x(0x01, w, h), lossy), "rejected")
    out["vp8x_iccp_unknown_chunks"] = (
        riff(vp8x(0x20, w, h), chunk(b"ICCP", b"icc"), chunk(b"ZZZZ", b"x" * 5), lossy,
             chunk(b"EXIF", b"exif")), "array")
    small = image_chunk(save(image(10, 20, 4, 3), lossless=True))
    full = image_chunk(save(image(30, 40, 4, 4), lossless=True))
    for flags in (0x12, 0x02):
        out[f"anmf_first_smaller_flags{flags:02x}"] = (
            riff(vp8x(flags, 40, 30), chunk(b"ANIM", struct.pack("<IH", 0xFF00FF00, 0)),
                 anmf(4, 6, 20, 10, small), anmf(0, 0, 40, 30, full)), "array")
    out["anmf_outside_canvas"] = (
        riff(vp8x(0x12, 40, 30), chunk(b"ANIM", struct.pack("<IH", 0, 0)),
             anmf(30, 6, 20, 10, small)), "rejected")
    return out


HAND_MADE = _hand_made()


@pytest.mark.parametrize("name", sorted(HAND_MADE))
def test_hand_made(name):
    data, outcome = HAND_MADE[name]
    assert contract(data) == outcome


def test_alpha_hint_0_is_opaque_though_the_pixels_are_not():
    """Pillow's mode decision: a VP8L whose alpha_is_used bit is 0 is
    Pillow's "RGB" (raw mode "RGBX"), so the array's alpha is 255, while
    the stream's own alpha (decoded as it is) holds zeros."""
    data = HAND_MADE["vp8l_alpha_hint_0"][0]
    rgba, _info = vp8l.decode_vp8l(data[20:])
    assert (rgba[..., 3] == 0).any()
    assert (imgio.load_image(data)[..., 3] == 255).all()


def test_first_anmf_leaves_the_canvas_zero():
    """A first frame smaller than the canvas: zeros around it (the ANIM
    background colour is not painted), the frame at its doubled offset."""
    data = HAND_MADE["anmf_first_smaller_flags12"][0]
    got = imgio.load_image(data)
    assert got.shape == (30, 40, 4)
    inside = np.zeros((30, 40), bool)
    inside[6:16, 4:24] = True
    assert (got[~inside] == 0).all() and got[inside].any()


# ---------------------------------------------------------------------------
# 3. damaged files
# ---------------------------------------------------------------------------

DAMAGED = {
    "lossy": lambda: save(image(20, 27, 3, 20), quality=70),
    "lossy_alpha": lambda: save(image(24, 24, 4, 21), quality=50, alpha_quality=100),
    "lossy_alpha_reduced": lambda: save(image(24, 24, 4, 22), quality=50, alpha_quality=30),
    "lossless": lambda: save(image(20, 27, 4, 23), lossless=True),
    "animation": lambda: save_all([image(16, 20, 4, 24 + k) for k in range(2)]),
}


@pytest.mark.parametrize("name", sorted(DAMAGED))
def test_damaged(name):
    """Cut at every few bytes, and bytes changed anywhere from a seed (and,
    as often again, inside the bitstream's payload, past its headers): the
    same array or ValueError in both packages."""
    data = DAMAGED[name]()
    rng = np.random.default_rng(sorted(DAMAGED).index(name))
    payload = data.find(b"VP8") + 8 + 10
    seen = set()
    for cut in range(8, len(data), max(1, len(data) // 40)):
        seen.add(contract(data[:cut]))
    for k in range(240):
        b = bytearray(data)
        for _ in range(1 + k % 3):
            b[int(rng.integers(0 if k < 120 else payload, len(b)))] = int(rng.integers(0, 256))
        seen.add(contract(bytes(b)))
    assert seen == {"array", "rejected"}


# ---------------------------------------------------------------------------
# 4. the native stages against their twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("simd", [False, True])
def test_transform_matches_twin(simd):
    """libwebp's inverse transforms on random 16-bit coefficients: its C
    code on the blocks it gives it (a DC term, or coefficients 0, 1 and 4
    alone), its SSE2 code on any block, extremes included (where its
    16-bit sums wrap and the C code's would not)."""
    rng = np.random.default_rng(int(simd))
    coeffs = rng.integers(-32768, 32768, (4000, 16)).astype(np.int16)
    coeffs[:1000] = rng.integers(-2048, 2048, (1000, 16))
    if not simd:
        coeffs[:, [2, 3, 5, 6, 7, *range(8, 16)]] = 0
    pred = rng.integers(0, 256, (4000, 4, 4), np.uint8)
    np.testing.assert_array_equal(vp8.transform(coeffs, pred, simd),
                                  vp8.transform_ref(coeffs, pred, simd))


@pytest.mark.parametrize("h, w", [(1, 1), (1, 2), (2, 1), (3, 5), (8, 9), (16, 16), (31, 30)])
def test_yuv_to_rgba_matches_twin(h, w):
    rng = np.random.default_rng(h * 100 + w)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    y = rng.integers(0, 256, (mb_h * 16, mb_w * 16), np.uint8)
    u = rng.integers(0, 256, (mb_h * 8, mb_w * 8), np.uint8)
    v = rng.integers(0, 256, (mb_h * 8, mb_w * 8), np.uint8)
    u[:2], v[:, :2] = 0, 255  # the clipping's ends
    np.testing.assert_array_equal(vp8.yuv_to_rgba(y, u, v, w, h),
                                  vp8.yuv_to_rgba_ref(y, u, v, w, h))


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_unfilter_matches_twin(filt):
    rng = np.random.default_rng(filt)
    for h, w in ((1, 1), (1, 9), (7, 1), (13, 21)):
        plane = rng.integers(0, 256, (h, w), np.uint8)
        np.testing.assert_array_equal(webp.unfilter(plane, filt), webp.unfilter_ref(plane, filt))


@pytest.mark.parametrize("kind, bits", [(0, 2), (0, 3), (1, 2), (1, 4), (2, 0), (3, 0), (3, 1),
                                        (3, 2), (3, 3)])
def test_inverse_transform_matches_twin(kind, bits):
    """Random pixels and transform data; the predictor over every mode
    (14 and 15 included), the colour map at each index width."""
    rng = np.random.default_rng(kind * 10 + bits)
    xsize, ysize = 21, 13
    if kind == 3:
        in_w = (xsize + (1 << bits) - 1) >> bits
        pixels = rng.integers(0, 1 << 32, (ysize, in_w), np.uint64).astype(np.uint32)
        tdata = rng.integers(0, 1 << 32, 1 << (8 >> bits), np.uint64).astype(np.uint32)
    else:
        pixels = rng.integers(0, 1 << 32, (ysize, xsize), np.uint64).astype(np.uint32)
        tiles = ((ysize + (1 << bits) - 1) >> bits) * ((xsize + (1 << bits) - 1) >> bits)
        tdata = rng.integers(0, 1 << 32, max(tiles, 1), np.uint64).astype(np.uint32)
        if kind == 0:
            tdata = (tdata & ~np.uint32(0xF00)) | ((np.arange(tdata.size) % 16).astype(
                np.uint32) << 8)
    np.testing.assert_array_equal(vp8l.inverse_transform(kind, bits, xsize, ysize, tdata, pixels),
                                  vp8l.inverse_transform_ref(kind, bits, xsize, ysize, tdata,
                                                             pixels))


# ---------------------------------------------------------------------------
# 5. what the saver reaches; the writer
# ---------------------------------------------------------------------------

def test_what_the_saver_reaches():
    """Pillow's lossy files use the normal loop filter or none (at quality
    100) and one token partition (the simple filter and 2-8 partitions,
    which the decoder also reads, only a VP8 encoder set up for them
    writes); its lossless
    files use all four transforms, the colour cache and meta codes."""
    filters, parts, transforms, cache, meta = set(), set(), set(), set(), set()
    for k, q in enumerate((0, 30, 80, 100)):
        data = save(image(64, 64, 3, 400 + k), quality=q, method=k + 2)
        *_planes, info = vp8.decode_vp8(data[20:])
        filters.add(info["filter_type"])
        parts.add(info["partitions"])
    for k, img in enumerate((image(64, 64, 4, 410), image(48, 40, 3, 411),
                             np.repeat(image(64, 8, 3, 412), 8, axis=1),
                             (image(64, 64, 3, 413) >> 6) << 6, mixed(64, 3, 414))):
        for method in (0, 4, 6):
            _rgba, info = vp8l.decode_vp8l(save(img, lossless=True, method=method)[20:])
            transforms |= {info[f"type{t}"] for t in range(info["transforms"])}
            cache.add(info["cache_bits"] > 0)
            meta.add(info["meta_bits"] > 0)
    assert filters == {0, 2} and parts == {1}
    assert transforms == {0, 1, 2, 3} and cache == {False, True} and True in meta


def test_webp_write_raises_value_error(tmp_path):
    """A .webp write raises NotImplementedError naming its ROADMAP item (the
    WebP encoder is unported; the test's name predates that contract)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        imgio.write_image_file(tmp_path / "t.webp", image(4, 4, 3, 0))
