"""The port's decoders of the remaining image formats against the JAX
package's imgio (Pillow 12.1), and its open decision.

1. Pillow's open decision (gatling_tpu_torch/imgio/identify.py): for
   every format in Pillow's Image.OPEN, a file of it, cut short at three
   places, and with bytes changed at three, each meet the contract of the
   port's imgio.load_image: where the JAX package returns an array, the
   port returns the same array (dtype, shape, every value) or raises
   NotImplementedError naming its ROADMAP item; where the JAX package
   raises ValueError, so does the port. Bytes no plugin takes raise
   ValueError in both.
2. A corpus written by Pillow inside the test from a numpy seed, every
   mode each saver takes (BMP, DIB, ICO, GIF, PPM, QOI, TGA, DDS, TIFF
   across its compressions, CMYK JPEG), and hand-made files of what Pillow
   does not write (RLE BMPs, BC4/BC6H/BC7 DDS, PSD, 16-bit TGA, TIFF
   layouts, JPEG sampling factors): the port's array equals the JAX
   package's bit for bit.
3. The native BC1-BC7 block decoders against their NumPy twins on random
   blocks, bit for bit (no tolerance).
4. Through TextureManager: the 1x1 black texel appears only where the JAX
   manager also gives it; a .webp texture builds the JAX manager's pool.
5. The writers of .bmp and the Netpbm extensions, byte for byte what
   Pillow saves for the same array.
"""

import importlib.util
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from gatling_tpu import imgio as jimgio
from gatling_tpu.render import texture as jtex

from gatling_tpu_torch import imgio
from gatling_tpu_torch.imgio import dds, identify
from gatling_tpu_torch.render import texture as ttex

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "imgio")
_spec = importlib.util.spec_from_file_location("make_fixtures",
                                               os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)


def same(got: np.ndarray, want: np.ndarray) -> bool:
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    return np.array_equal(got, want) if got.dtype == bool else got.tobytes() == want.tobytes()


def contract(data: bytes) -> str:
    """Checks the port's load_image against the JAX package's on `data`;
    returns what both did ("array", "unported" or "rejected")."""
    try:
        want = jimgio.load_image(data).data
    except ValueError:
        with pytest.raises(ValueError):
            imgio.load_image(data)
        return "rejected"
    try:
        got = imgio.load_image(data)
    except NotImplementedError as e:
        assert "ROADMAP" in str(e), e
        return "unported"
    assert same(got, want), (got.dtype, want.dtype, got.shape, want.shape)
    return "array"


def check(data: bytes) -> np.ndarray:
    want = jimgio.load_image(data).data
    got = imgio.load_image(data)
    assert same(got, want), (got.dtype, want.dtype, got.shape, want.shape)
    return got


def _pil(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# 1. the open decision, for every format in Image.OPEN
# ---------------------------------------------------------------------------

def _header_only(name: str) -> bytes:
    """A file of each format Pillow has no writer for here, as far as its
    plugin reads it."""
    rng = np.random.default_rng(len(name))
    noise = rng.integers(0, 256, 600, np.uint8).tobytes()
    if name == "BUFR":
        return b"BUFR" + noise
    if name == "GRIB":
        return b"GRIB\0\0\0\1" + noise
    if name == "HDF5":
        return b"\x89HDF\r\n\x1a\n" + noise
    if name == "CUR":
        return mf.cur_file(mf.double_height(mf.pillow(mf.texture(8, 8, 3, 1), "DIB")), 8, 8)
    if name == "DCX":
        pcx = _pil(Image.fromarray(mf.texture(8, 8, 3, 2)), "PCX")
        return struct.pack("<II", 987654321, 12) + b"\0\0\0\0" + pcx
    if name == "FITS":
        cards = [b"SIMPLE  =                    T", b"BITPIX  =                    8",
                 b"NAXIS   =                    2", b"NAXIS1  =                    6",
                 b"NAXIS2  =                    5", b"END"]
        head = b"".join(c.ljust(80) for c in cards).ljust(2880)
        return head + noise[:30].ljust(2880, b"\0")
    if name == "FLI":
        head = bytearray(128)
        struct.pack_into("<IHHHHH", head, 0, 128 + 16, 0xAF12, 1, 8, 6, 8)
        return bytes(head) + struct.pack("<IHH", 16, 0xF1FA, 0) + b"\0" * 8
    if name == "FTEX":
        px = mf.texture(4, 4, 3, 3).tobytes()
        return b"FTEX" + struct.pack("<i2i2i2i", 1, 4, 4, 1, 1, 1, 32) + struct.pack(
            "<i", len(px)) + px
    if name == "GBR":
        return struct.pack(">5I", 28, 2, 4, 3, 1) + b"GIMP" + struct.pack(">I", 10) \
            + noise[:12]
    if name == "ICNS":
        png = _pil(Image.fromarray(mf.texture(16, 16, 4, 4)), "PNG")
        body = b"icp4" + struct.pack(">I", 8 + len(png)) + png
        return b"icns" + struct.pack(">I", 8 + len(body)) + body
    if name == "IMT":
        return b"width 6\nheight 4\npixel n8\n\x0c" + noise[:24]
    if name == "IPTC":
        def field(rec, tag, data):
            return bytes([0x1C, rec, tag]) + struct.pack(">H", len(data)) + data
        return (field(3, 60, b"\1\0") + field(3, 20, b"\0\6") + field(3, 30, b"\0\4")
                + field(3, 120, b"\0\1") + field(8, 10, b"") + noise[:24])
    if name == "MCIDAS":
        head = np.zeros(64, ">i4")
        head[1], head[8], head[9], head[10], head[13] = 4, 4, 6, 1, 1
        head[33] = 256
        return b"\0\0\0\0\0\0\0\4" + head.tobytes()[8:] + noise[:24]
    if name == "MPEG":
        return b"\x00\x00\x01\xb3\x01\x00\xf0\x11" + noise[:40]
    if name == "PCD":
        return b"\0" * 2048 + b"PCD_IPI" + noise[:1532] + b"\0" * 4000
    if name == "PIXAR":
        head = bytearray(1024)
        head[:4] = b"\200\350\000\000"
        struct.pack_into("<HH", head, 416, 4, 6)
        struct.pack_into("<HH", head, 424, 14, 2)
        return bytes(head) + noise[:72]
    if name == "SUN":
        return struct.pack(">8I", 0x59A66A95, 6, 4, 8, 24, 1, 0, 0) + noise[:24]
    if name == "WMF":
        return b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<hhhhH", 0, 0, 100, 100, 72) \
            + b"\0" * 6 + b"\x01\x00\t\x00" + noise[:40]
    if name == "XPM":
        return (b'/* XPM */\nstatic char *x[] = {\n"3 2 2 1",\n"a c #ff0000",\n'
                b'"b c #0000ff",\n"aba",\n"bab"\n};\n')
    if name == "XVTHUMB":
        return b"P7 332\n#XVVERSION\n#END_OF_COMMENTS\n4 3 255\n" + noise[:12]
    if name == "EPS":
        return b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 4 4\n" + noise[:40]
    raise KeyError(name)


def format_file(name: str) -> bytes:
    """A small valid file of Pillow's plugin `name`."""
    rgb = Image.fromarray(mf.texture(10, 13, 3, 5))
    saved = {"BMP": ("BMP", rgb), "DIB": ("DIB", rgb), "GIF": ("GIF", rgb),
             "JPEG": ("JPEG", rgb), "PPM": ("PPM", rgb), "PNG": ("PNG", rgb),
             "AVIF": ("AVIF", rgb), "BLP": ("BLP", rgb.quantize(16)), "PCX": ("PCX", rgb),
             "DDS": ("DDS", rgb), "JPEG2000": ("JPEG2000", rgb),
             "ICO": ("ICO", Image.fromarray(mf.texture(16, 16, 4, 8))),
             "IM": ("IM", rgb), "TIFF": ("TIFF", rgb), "MSP": ("MSP", rgb.convert("1")),
             "PSD": None, "QOI": ("QOI", rgb), "SGI": ("SGI", rgb),
             "SPIDER": ("SPIDER", rgb.convert("F")), "TGA": ("TGA", rgb),
             "WEBP": ("WEBP", rgb), "XBM": ("XBM", rgb.convert("1"))}
    if name == "PSD":
        return mf.psd_file(mf.texture(10, 13, 3, 6).transpose(2, 0, 1).copy(), 3)
    if saved.get(name):
        fmt, im = saved[name]
        return _pil(im, fmt)
    return _header_only(name)


def _variants(data: bytes, seed: int):
    rng = np.random.default_rng(seed)
    yield "whole", data
    for k, frac in enumerate((0.2, 0.5, 0.9)):
        yield f"cut{k}", data[:int(len(data) * frac)]
    for k in range(3):
        b = bytearray(data)
        for _ in range(2):
            i = int(rng.integers(0, min(len(b), 160)))
            b[i] = int(rng.integers(0, 256))
        yield f"flip{k}", bytes(b)


PILLOW_OPEN = [name for name, _accept in identify.PLUGINS]
# Compressed formats the port does not decode, whose damaged data the JAX
# package rejects while the port, which cannot tell without their decoder,
# raises NotImplementedError (ROADMAP Queue 3): both give no image.
DAMAGE_UNSEEN = ("AVIF",)


def test_plugin_order_is_pillows():
    """identify.PLUGINS lists Pillow 12.1's plugins in the order Image.open
    tries them (Image.ID after Image.preinit and Image.init)."""
    from PIL import Image as PILImage

    PILImage.preinit()
    PILImage.init()
    assert sorted(PILLOW_OPEN) == sorted(PILImage.OPEN)
    first = [n for n in PILImage.ID if n in ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG")]
    rest = [n for n in PILLOW_OPEN if n not in first]
    assert PILLOW_OPEN == first + rest and rest == sorted(rest, key=PILLOW_OPEN.index)


def _no_image(blob: bytes) -> None:
    """Where the JAX package decodes a damaged file of DAMAGE_UNSEEN, the
    port still meets the contract; where it rejects it, the port raises
    (NotImplementedError or ValueError)."""
    try:
        jimgio.load_image(blob)
    except ValueError:
        imgio.load_image(blob)
        raise AssertionError("the port decoded a file the JAX package rejects")
    contract(blob)
    raise ValueError("decoded by the JAX package, the contract met")


@pytest.mark.parametrize("name", PILLOW_OPEN)
def test_open_decision_meets_the_contract(name):
    """Every format in Image.OPEN, whole, cut and corrupted: the same array
    or NotImplementedError where the JAX package decodes, ValueError where
    it does not. The ported formats decode their whole file."""
    data = format_file(name)
    seen = {}
    for label, blob in _variants(data, PILLOW_OPEN.index(name)):
        if name in DAMAGE_UNSEEN and label != "whole":
            with pytest.raises((NotImplementedError, ValueError)):
                _no_image(blob)
            continue
        seen[label] = contract(blob)
    ported = name not in identify.UNPORTED_OPEN
    if ported:
        assert "unported" not in seen.values(), seen
        # the PCD and IPTC samples are headers over noise, which Pillow
        # cannot load either (tests/test_torch_imgio_legacy.py has whole ones)
        assert seen["whole"] == ("rejected" if name in ("PCD", "IPTC") else "array"), seen
    elif name in ("EPS", "WMF", "BUFR", "GRIB", "HDF5", "MPEG"):
        assert seen["whole"] == "rejected", seen  # Pillow cannot load these here


@pytest.mark.parametrize("data", [b"", b"\0", b"\0" * 5, b"hello, world", b"P7 foo",
                                  b"\x89PNG\r\n\x1a\n", b"RIFF\0\0\0\0WEBPVP8 ",
                                  bytes(range(256)) * 3])
def test_bytes_no_plugin_takes_raise_value_error(data):
    assert contract(data) == "rejected"


def test_webp_and_ppm_were_black_and_now_are_not():
    """The fault PR 16 left: a WebP, PPM or ICO the port could not read
    raised ValueError, which the texture manager turns into the black
    texel, while the JAX package renders the image. Now all three decode
    to the JAX package's array."""
    rgb = Image.fromarray(mf.texture(16, 16, 3, 7))
    check(_pil(rgb, "WEBP"))
    check(_pil(rgb, "PPM"))
    check(_pil(rgb, "ICO"))


# ---------------------------------------------------------------------------
# 2. a seeded corpus, bit for bit
# ---------------------------------------------------------------------------

MODES = ("1", "L", "LA", "P", "RGB", "RGBA", "I;16", "I", "F", "CMYK")
SAVERS = {"BMP": {}, "DIB": {}, "GIF": {}, "GIF-interlaced": {"interlace": True},
          "GIF-transparent": {"transparency": 3}, "PPM": {}, "QOI": {}, "TGA": {},
          "TGA-rle": {"compression": "tga_rle"}, "ICO": {}, "ICO-bmp": {"bitmap_format": "bmp"},
          "DDS": {}, "DDS-DXT1": {"pixel_format": "DXT1"}, "DDS-DXT3": {"pixel_format": "DXT3"},
          "DDS-DXT5": {"pixel_format": "DXT5"}, "DDS-BC5": {"pixel_format": "BC5"},
          "TIFF": {}, "TIFF-lzw": {"compression": "tiff_lzw"},
          "TIFF-deflate": {"compression": "tiff_adobe_deflate"},
          "TIFF-packbits": {"compression": "packbits"},
          "TIFF-tiles": {"compression": "tiff_lzw", "tiffinfo": {322: 16, 323: 16}},
          "TIFF-bigtiff": {"big_tiff": True}, "TIFF-jpeg": {"compression": "jpeg"},
          "JPEG": {}}


@pytest.mark.parametrize("saver", sorted(SAVERS))
def test_pillow_corpus(saver):
    """Every mode Pillow's saver takes, at a few sizes from a seed: the
    contract on each file Pillow writes (some it cannot read back: an ICO
    smaller than its smallest size, run-length 1-bit TGA), and arrays
    bit-equal wherever the JAX package decodes."""
    fmt = saver.split("-")[0]
    rng = np.random.default_rng(sorted(SAVERS).index(saver))
    written = decoded = 0
    for h, w in ((1, 1), (5, 3), (17, 23), (32, 40)):
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        img[..., 3] = rng.choice([0, 7, 128, 255], (h, w))
        for mode in MODES:
            if fmt == "TIFF" and saver.endswith("jpeg") and mode not in ("L", "RGB", "CMYK"):
                continue  # libtiff's JPEG codec takes 8-bit grey, RGB and CMYK alone
            im = Image.fromarray(img).convert(mode) if mode != "I;16" else Image.frombytes(
                "I;16", (w, h), (img[..., 0].astype("<u2") * 257).tobytes())
            try:
                data = _pil(im, fmt, **SAVERS[saver])
            except (OSError, ValueError, KeyError, TypeError):
                continue  # a mode this saver does not take
            written += 1
            decoded += contract(data) == "array"
    assert written and decoded


def test_hand_made_files():
    """What Pillow does not write: RLE8/RLE4 BMPs (deltas, absolute runs,
    end of line), BITFIELDS BMPs, core-header BMPs, a PSD of every mode
    Pillow reads, raw and PackBits, 16-bit TGA and colour maps, TIFF
    layouts (1/2/4/12/32-bit, signed, palette, planar 2, fill order 2,
    old-style LZW) and JPEGs of sampling factors up to 4."""
    rng = np.random.default_rng(11)
    tex = mf.texture(18, 22, 4, 12)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    check(mf.bmp_rle8(rng.integers(0, 200, (13, 17)).astype(np.uint8), pal))
    for bits, comp in ((8, 1), (4, 2)):
        body = bytes([3, 5, 0, 0, 0, 4, 1, 2, 3, 4, 0, 2, 1, 1, 2, 7, 0, 0, 0, 1])
        info = struct.pack("<IiiHHIIiiII", 40, 9, 4, 1, bits, comp, len(body), 0, 0, 0, 0)
        n = 1 << bits
        palette = np.concatenate([pal[:n, ::-1], np.zeros((n, 1), np.uint8)], 1).tobytes()
        off = 14 + 40 + len(palette)
        check(b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info + palette + body)
    for masks in ((0xF800, 0x7E0, 0x1F, 0), (0xFF, 0xFF00, 0xFF0000, 0xFF000000)):
        bits = 16 if masks[0] == 0xF800 else 32
        px = rng.integers(0, 256, ((bits // 8 * 7 + 3) & ~3) * 5, np.uint8).tobytes()
        info = struct.pack("<IiiHHIIiiII", 56, 7, -5, 1, bits, 3, len(px), 0, 0, 0, 0) \
            + struct.pack("<4I", *masks)
        check(b"BM" + struct.pack("<IHHI", 14 + 56 + len(px), 0, 0, 70) + info + px)
    core = struct.pack("<IHHHH", 12, 6, 3, 1, 8) + pal.tobytes() + bytes(range(24))
    check(b"BM" + struct.pack("<IHHI", 14 + len(core), 0, 0, 14 + 12 + 768) + core)
    for mode, chans in ((3, 3), (3, 4), (3, 5), (4, 4), (1, 1), (1, 2), (9, 3), (8, 1)):
        planes = tex[..., :1].repeat(chans, -1).transpose(2, 0, 1).copy() ^ np.arange(
            chans, dtype=np.uint8)[:, None, None]
        for comp in (0, 1):
            check(mf.psd_file(planes, mode, comp))
    check(mf.tga16(tex[..., :3]))
    cmap16 = rng.integers(0, 65536, 5, np.uint16).astype("<u2").tobytes()
    check(struct.pack("<BBBHHBHHHHBB", 0, 1, 1, 2, 5, 16, 0, 0, 3, 2, 8, 0x20) + cmap16
          + bytes([0, 1, 2, 3, 6, 7]))
    check(struct.pack("<BBBHHBHHHHBB", 0, 0, 3, 0, 0, 0, 0, 0, 11, 3, 1, 0x20)
          + rng.integers(0, 256, 6, np.uint8).tobytes())
    grey = mf.texture(9, 10, 1, 13)[..., 0]
    for bits in (1, 2, 4):
        v = grey >> (8 - bits)
        packed = np.packbits(((v[..., None] >> np.arange(bits - 1, -1, -1)) & 1)
                             .reshape(9, -1).astype(np.uint8), axis=1)
        for photo in (0, 1):
            check(mf.tiff_file([packed.tobytes()], 10, 9, 9, {258: (3, [bits]),
                                                             262: (3, [photo])}))
        cmap = rng.integers(0, 65536, 3 << bits).tolist()
        check(mf.tiff_file([packed.tobytes()], 10, 9, 9, {258: (3, [bits]), 262: (3, [3]),
                                                         320: (3, cmap)}))
    v12 = (grey.astype(np.uint16) << 4).ravel()
    packed12 = np.stack([v12[0::2] >> 4, ((v12[0::2] & 15) << 4) | (v12[1::2] >> 8),
                         v12[1::2] & 255], 1).astype(np.uint8)
    check(mf.tiff_file([packed12.tobytes()], 10, 9, 9, {258: (3, [12]), 262: (3, [1])}))
    for fmt, dt in ((1, "<u4"), (2, "<i4")):
        vals = (grey.astype(np.int64) * 70001 - 9000000).astype(dt).tobytes()
        check(mf.tiff_file([vals], 10, 9, 9, {258: (3, [32]), 262: (3, [1]), 339: (3, [fmt])}))
    check(mf.tiff_file([(grey.astype(np.int16) * 200 - 25000).astype(">i2").tobytes()], 10, 9,
                       9, {258: (3, [16]), 262: (3, [1]), 339: (3, [2])}, bo=">"))
    planar = tex[..., :4]
    check(mf.tiff_file([planar[..., c].tobytes() for c in range(4)], 22, 18, 18,
                       {258: (3, [8] * 4), 262: (3, [2]), 277: (3, [4]), 284: (3, [2]),
                        338: (3, [2])}))
    rev = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)
    check(mf.tiff_file([rev[grey].tobytes()], 10, 9, 9, {262: (3, [1]), 258: (3, [8]),
                                                       266: (3, [2])}))
    check(mf.tiff_file([mf.lzw_old(tex[..., :3].tobytes())], 22, 18, 18,
                       {258: (3, [8] * 3), 262: (3, [2]), 259: (3, [5]), 277: (3, [3])}))
    for factors in ([(4, 1), (1, 1), (1, 1)], [(3, 1), (1, 1), (1, 1)], [(1, 4), (1, 1), (1, 1)],
                    [(4, 2), (1, 1), (1, 1)], [(2, 2), (1, 1), (2, 1)], [(1, 1), (2, 2), (1, 1)],
                    [(3, 2), (1, 1), (1, 1)], [(4, 1)]):
        check(mf.jpeg_sampled(mf.texture(21, 29, 3, 14), factors, 15))
    # 11 blocks an MCU: libjpeg's limit is 10, and both packages reject it
    assert contract(mf.jpeg_sampled(mf.texture(21, 29, 3, 14), [(3, 3), (1, 1), (1, 1)],
                                    15)) == "rejected"
    for adobe in (None, 0, 1, 2):
        check(mf.jpeg_sampled(mf.texture(21, 29, 4, 16), [(2, 2), (1, 1), (1, 1), (2, 2)], 17,
                              adobe=adobe))


# TGA headers Pillow opens but cannot load: no raw mode for the type and
# depth ("cannot load this image"), or a colour map on a 1-bit, RGB or RGBA
# image (its palette cannot be put on such an image); 4x4, top-left
TGA_REFUSED = {"rgb8": (2, 8, 0), "rgb1": (2, 1, 0), "grey24": (3, 24, 0), "grey32": (3, 32, 0),
               "mapped16": (1, 16, 1), "rle_rgb8": (10, 8, 0), "rle_grey24": (11, 24, 0),
               "rgb24_mapped": (2, 24, 1), "rgba32_mapped": (2, 32, 1), "grey1_mapped": (3, 1, 1),
               "rle_mapped32": (9, 32, 1), "rle_rgb1": (10, 1, 0)}


@pytest.mark.parametrize("name", sorted(TGA_REFUSED))
def test_tga_headers_pillow_refuses(name):
    itype, depth, cmap = TGA_REFUSED[name]
    rng = np.random.default_rng(sorted(TGA_REFUSED).index(name))
    head = struct.pack("<BBBHHBHHHHBB", 0, cmap, itype, 0, 4 if cmap else 0, 24 if cmap else 0,
                       0, 0, 4, 4, depth, 0x20)
    data = head + (bytes(12) if cmap else b"") + rng.integers(0, 256, 160, np.uint8).tobytes()
    assert contract(data) == "rejected"


@pytest.mark.parametrize("dxgi", [71, 74, 77, 80, 83, 84, 95, 96, 98, 28])
def test_dds_dx10_random_blocks(dxgi):
    """Every DXGI format the port reads (BC1-BC7, signed BC5 and BC6H, raw
    RGBA), random blocks at odd sizes."""
    for k, (w, h) in enumerate(((1, 1), (5, 3), (13, 9), (16, 16))):
        size = 8 if dxgi in (71, 80) else 16
        if dxgi == 28:
            data = mf.dds_header(w, h, b"DX10", 28) + np.random.default_rng(k).integers(
                0, 256, w * h * 4, np.uint8).tobytes()
        else:
            data = mf.dds_blocks(w, h, dxgi, 100 * dxgi + k, size)
        check(data)


def test_jpeg_dnl_and_precision_are_rejected_as_pillow_rejects_them():
    """A frame whose height only a DNL marker gives, and 12-bit samples:
    Pillow (over libjpeg-turbo) reads neither, so both raise ValueError. A
    DNL marker after a frame whose SOF gives its height decodes as usual."""
    base = mf.jpeg_sampled(mf.texture(16, 16, 3, 18), [(2, 2), (1, 1), (1, 1)], 19)
    k = base.find(b"\xff\xc0")
    dnl = bytearray(base)
    dnl[k + 5:k + 7] = b"\0\0"
    dnl = bytes(dnl[:-2]) + b"\xff\xdc\x00\x04\x00\x10\xff\xd9"
    twelve = bytearray(base)
    twelve[k + 4] = 12
    for data in (dnl, bytes(twelve)):
        assert contract(data) == "rejected"
    check(base[:-2] + b"\xff\xdc\x00\x04\x00\x10\xff\xd9")  # a DNL after a sized frame


# ---------------------------------------------------------------------------
# 3. the BCn block decoders against their twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,sign", [(1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (5, 1), (6, 0),
                                      (6, 1), (7, 0)])
def test_bcn_native_matches_numpy_twin(fmt, sign):
    """gatling_bcn_decode against bcn_decode_ref on random blocks (BC7:
    every mode; BC6H: every mode code, the invalid ones too), bit for bit."""
    rng = np.random.default_rng(10 * fmt + sign)
    w, h = 37, 22
    n = ((w + 3) // 4) * ((h + 3) // 4)
    size = dds.block_bytes(fmt)
    blocks = rng.integers(0, 256, (n, size), np.uint8)
    if fmt == 7:
        blocks[:, 0] = 1 << (np.arange(n) % 9) % 256
    if fmt == 6:
        codes = np.array([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23])
        blocks[:, 0] = (blocks[:, 0] & 0xE0) | codes[np.arange(n) % len(codes)]
    raw = blocks.tobytes()
    np.testing.assert_array_equal(dds.bcn_decode(raw, fmt, sign, w, h),
                                  dds.bcn_decode_ref(raw, fmt, sign, w, h))


# ---------------------------------------------------------------------------
# 4. the texture manager
# ---------------------------------------------------------------------------

def test_black_texel_only_where_the_jax_manager_gives_it(tmp_path):
    """Textures of the new formats (a .webp among them), one cut short, one
    in a format neither package reads: both managers build the same pool
    (the 1x1 black texel for the two bad files alone)."""
    webp = tmp_path / "t.webp"
    webp.write_bytes(_pil(Image.fromarray(mf.texture(8, 8, 3, 20)), "WEBP"))
    names = ["bmp_rgb24.bmp", "gif_palette.gif", "dds_bc7.dds", "psd_rgb.psd", "qoi_rgba.qoi",
             "tga_rgb16.tga", "tiff_palette.tif", "jpeg_cmyk.jpg", "ppm_rgb.ppm"]
    paths = [os.path.join(FIXTURES, n) for n in names] + [str(webp)]
    names.append("t.webp")
    with open(paths[2], "rb") as f:
        (tmp_path / "cut.dds").write_bytes(f.read()[:300])
    (tmp_path / "none.xyz").write_bytes(b"not an image at all")
    paths += [str(tmp_path / "cut.dds"), str(tmp_path / "none.xyz")]
    pools = [lib.TextureManager().build_pool([lib.TextureRef(file_path=p) for p in paths])
             for lib in (jtex, ttex)]
    jp, tp = pools
    for field in ttex.TexturePool._fields:
        ref, got = np.asarray(getattr(jp, field)), getattr(tp, field).numpy()
        if ref.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, ref, err_msg=field)
    widths = tp.width.numpy()
    assert (widths[:len(names)] > 1).all() and (widths[len(names):] == 1).all()


# ---------------------------------------------------------------------------
# 5. writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext", [".bmp", ".ppm", ".pgm", ".pbm", ".pnm", ".pfm"])
@pytest.mark.parametrize("shape", [(5, 7), (6, 3, 1), (4, 9, 3), (9, 4, 4), (1, 1, 3)])
def test_writers_are_pillows_bytes(tmp_path, ext, shape):
    """The port's .bmp and Netpbm writers write the bytes Pillow
    saves for the same array (8-bit codes, and floats scaled and rounded)."""
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    for arr in (rng.integers(0, 256, shape).astype(np.uint8),
                rng.uniform(0, 1, shape).astype(np.float32)):
        imgio.write_image_file(tmp_path / f"p{ext}", arr)
        jimgio.write_image_file(tmp_path / f"j{ext}", arr)
        assert (tmp_path / f"p{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
        check((tmp_path / f"p{ext}").read_bytes())
