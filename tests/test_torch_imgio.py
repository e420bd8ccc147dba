"""The port's image codecs against the JAX package's imgio (Pillow 12 over
libjpeg-turbo and libtiff).

1. Every committed fixture (tests/data/imgio, written by its
   make_fixtures.py with Pillow) decodes in the port to the array that
   gatling_tpu.imgio.load_image gives, dtype and codes bit-equal, and to
   the array fixtures.npz keeps for the card's machine, which has no
   Pillow (the 1024^2 WebP ones: to its SHA-256 digest).
2. Files generated here from a numpy seed, decoded by both packages, bit
   for bit:
   - JPEG: Pillow's baseline at 4:2:0, 4:2:2 and 4:4:4, restart intervals,
     optimised Huffman tables, progressive (also with restarts), grey, at
     odd widths and heights; 4:4:0, which Pillow does not write, through
     the port's encoder;
   - PNG: every colour type and bit depth (1, 2, 4, 8, 16), Adam7
     interlaced or not, with and without tRNS, every row filter;
   - TGA: Pillow's raw and run-length files, and hand-made ones (a colour
     map that starts past entry 0, all four origins; a packet across rows
     raises in both);
   - TIFF: every layout the port reads, in strips, one strip or tiles,
     little- or big-endian, uncompressed, LZW, Deflate (both tags) and
     PackBits, predictors 1, 2 and 3.
3. The port's writers, read back by Pillow: TGA and TIFF codes equal; a
   JPEG decodes (in Pillow) to what Pillow's own file at the same settings
   decodes to, code for code, with no tolerance.
4. Unported variants raise NotImplementedError naming the ROADMAP item
   (the formats ported since: tests/test_torch_imgio_formats.py), and
   bytes Pillow rejects raise ValueError in both packages; an
   undecodable texture renders the 1x1 black fallback and logs an error in
   both packages.
"""

import importlib.util
import io
import logging
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from gatling_tpu import imgio as jimgio
from gatling_tpu.render import texture as jtex

from gatling_tpu_torch import imgio
from gatling_tpu_torch.imgio import jpeg
from gatling_tpu_torch.render import texture as ttex

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "imgio")
_spec = importlib.util.spec_from_file_location("make_fixtures",
                                               os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)
NAMES = sorted(f for f in os.listdir(FIXTURES) if not f.endswith((".py", ".npz")))
SIZES = [(1, 1), (2, 3), (3, 5), (8, 8), (9, 9), (15, 17), (17, 33), (31, 7), (64, 48)]


def same(got: np.ndarray, want: np.ndarray) -> bool:
    """dtype and shape equal, and every value bit for bit (a bool array by
    value: Pillow's "1" arrays hold 255 for True)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    return np.array_equal(got, want) if got.dtype == bool else got.tobytes() == want.tobytes()


def check(data: bytes) -> np.ndarray:
    want = jimgio.load_image(data).data
    got = imgio.load_image(data)
    assert same(got, want), (got.dtype, want.dtype, got.shape, want.shape)
    return got


# ---------------------------------------------------------------------------
# 1. fixtures
# ---------------------------------------------------------------------------

def test_fixtures_are_current():
    """make_fixtures.py writes the committed files, byte for byte."""
    made = mf.fixtures()
    assert sorted(made) == NAMES
    for name, data in made.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name


@pytest.mark.parametrize("name", NAMES)
def test_fixture_decodes_as_jax(name):
    """The JAX package's array, and the one fixtures.npz keeps (for the
    1024^2 WebP fixtures, its digest)."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    got = check(data)
    kept = np.load(os.path.join(FIXTURES, "fixtures.npz"))[name]
    if name in mf.DIGESTED:
        assert np.array_equal(mf.digest(got), kept)
    else:
        assert same(got, kept)


# ---------------------------------------------------------------------------
# 2. generated files
# ---------------------------------------------------------------------------

JPEG_OPTIONS = {
    "420": {}, "422": {"subsampling": 1}, "444": {"subsampling": 0},
    "q95": {"quality": 95, "subsampling": 2}, "q20": {"quality": 20},
    "restart": {"restart_marker_blocks": 1}, "restart_rows": {"restart_marker_rows": 1},
    "optimize": {"optimize": True}, "progressive": {"progressive": True},
    "progressive_444": {"progressive": True, "subsampling": 0},
    "progressive_restart": {"progressive": True, "restart_marker_rows": 1},
}


@pytest.mark.parametrize("option", sorted(JPEG_OPTIONS))
@pytest.mark.parametrize("grey", [False, True])
def test_jpeg_decoder_matches_pillow(option, grey):
    rng = np.random.default_rng(len(option) + 7 * grey)
    for k, (h, w) in enumerate(SIZES):
        img = mf.texture(h, w, 1 if grey else 3, k) if k % 2 else \
            rng.integers(0, 256, (h, w, 1 if grey else 3), dtype=np.uint8)
        check(mf.pillow(img, "JPEG", **JPEG_OPTIONS[option]))


@pytest.mark.parametrize("sampling", [(1, 2), (2, 1), (1, 1), (2, 2)])
def test_jpeg_sampling_factors(sampling):
    """Every luma sampling factor over 1x1 chroma (4:4:0 too, which Pillow
    does not write) through the port's encoder, decoded by both."""
    rng = np.random.default_rng(sum(sampling))
    for h, w in SIZES:
        check(jpeg.encode_jpeg(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                               quality=int(rng.integers(30, 96)), sampling=sampling))


PNG_MODES = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16), (4, 8), (4, 16), (6, 8),
                                                    (6, 16)] + [(3, d) for d in (1, 2, 4, 8)]


@pytest.mark.parametrize("ctype,depth", PNG_MODES)
def test_png_decoder_matches_pillow(ctype, depth):
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(ctype * 17 + depth)
    for h, w in SIZES + [(40, 2)]:
        for interlace in (False, True):
            for with_trns in (False, True):
                px = rng.integers(0, 1 << depth, (h, w, chans)).astype(
                    np.uint16 if depth == 16 else np.uint8)
                palette = trns = None
                if ctype == 3:  # a palette shorter than the indices reach: black past its end
                    palette = rng.integers(0, 256, 3 * int(rng.integers(1, (1 << depth) + 1)),
                                           dtype=np.uint8).tobytes()
                if with_trns:
                    trns = {0: b"\x00\x01", 2: b"\x00\x01\x00\x02\x00\x03", 4: None, 6: None,
                            3: rng.integers(0, 256, 3, dtype=np.uint8).tobytes()}[ctype]
                check(mf.raw_png(px, interlace, depth, ctype, palette, trns))


def _tga(w, h, itype, depth, pixels, flags=0x20, cmap=b"", cstart=0, ident=b""):
    header = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap else 0, itype, cstart,
                         len(cmap) // 3, 24 if cmap else 0, 0, 0, w, h, depth, flags)
    return header + ident + cmap + pixels


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
@pytest.mark.parametrize("rle", [False, True])
def test_tga_decoder_matches_pillow(mode, rle):
    rng = np.random.default_rng(len(mode) + rle)
    for h, w in SIZES:
        chans = {"RGB": 3, "RGBA": 4, "L": 1, "P": 1}[mode]
        img = mf.texture(h, w, chans, h * w)
        img[: h // 2] = img[0]  # long runs for the run-length packets
        im = Image.fromarray(img.squeeze(-1) if chans == 1 else img)
        if mode == "P":
            im = im.quantize(int(rng.integers(2, 200)))
        for orientation in (1, -1):
            buf = io.BytesIO()
            im.save(buf, "TGA", rle=rle, orientation=orientation)
            check(buf.getvalue())


def test_tga_hand_made_files():
    """A colour map from entry 2 (indices below it and past its end black),
    an id field, all four origins, 16-bit grey; a run-length packet across
    rows raises ValueError in both packages."""
    rng = np.random.default_rng(3)
    cmap = rng.integers(0, 256, 3 * 5, dtype=np.uint8).tobytes()
    check(_tga(4, 2, 1, 8, bytes([0, 1, 2, 3, 6, 7, 8, 255]), 0x20, cmap, 2, b"id!"))
    packets = bytes([0x82, 9, 8, 7, 0x00, 1, 2, 3, 0x01, 4, 5, 6, 7, 8, 9, 0x81, 6, 5, 4])
    for flags in (0x00, 0x10, 0x20, 0x30, 0x28):
        check(_tga(4, 2, 10, 24, packets, flags))
    across = _tga(4, 2, 10, 24, bytes([0x84, 9, 8, 7, 0x02, 1, 2, 3, 4, 5, 6, 7, 8, 9]))
    for lib in (imgio, jimgio):  # a packet across rows: Pillow's decoder overruns
        with pytest.raises(ValueError):
            lib.load_image(across)
        check(_tga(3, 2, 2, 32, rng.integers(0, 256, 24, dtype=np.uint8).tobytes(), flags))
    check(_tga(3, 2, 3, 16, rng.integers(0, 256, 12, dtype=np.uint8).tobytes()))
    check(_tga(3, 2, 11, 8, bytes([0x81, 5, 0x00, 1, 0x02, 2, 3, 4])))


def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (libtiff's LZWEncode): MSB-first codes, the width growing
    as the next code reaches it, a Clear before the table fills."""
    out, acc, nacc, nbits = bytearray(), 0, 0, 9

    def put(code):
        nonlocal acc, nacc
        acc, nacc = (acc << nbits) | code, nacc + nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8

    put(256)
    table, nxt, w = {bytes([i]): i for i in range(256)}, 258, b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc], nxt = nxt, nxt + 1
        if nxt == 4094:
            put(256)
            table, nxt, nbits = {bytes([i]): i for i in range(256)}, 258, 9
        elif nxt > (1 << nbits) - 1:
            nbits += 1
        w = bytes([c])
    if w:
        put(table[w])
        if nxt + 1 > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _packbits(row: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(row):
        run = 1
        while i + run < len(row) and row[i + run] == row[i] and run < 128:
            run += 1
        if run > 1:
            out += bytes([257 - run, row[i]])
            i += run
            continue
        j = i + 1
        while j < len(row) and j - i < 128 and (j + 1 >= len(row) or row[j + 1] != row[j]):
            j += 1
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def write_tiff(samples, photo, extra=(), bo="<", compression=1, predictor=1,
               rows_per_strip=None, tile=None, fmt=None) -> bytes:
    """A TIFF of samples [h, w, spp] (uint8, uint16 or float32) in strips
    or tiles, every compression and predictor the port reads."""
    h, w, spp = samples.shape
    bits = samples.dtype.itemsize * 8
    uint = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]

    def encode(block):  # block [r, cw, spp] -> the chunk's bytes
        r = block.shape[0]
        if predictor == 3:  # byte planes MSB first, bytes differenced
            planes = block.astype(">f4").view(np.uint8).reshape(r, -1, 4).transpose(0, 2, 1)
            b = planes.reshape(r, -1, spp).astype(np.int64)
            b[:, 1:] = b[:, 1:] - planes.reshape(r, -1, spp)[:, :-1]
            raw = (b & 255).astype(np.uint8).tobytes()
        else:
            v = block.view(uint).astype(np.int64)
            if predictor == 2:
                v[:, 1:] = v[:, 1:] - block.view(uint)[:, :-1]
            raw = (v & ((1 << bits) - 1)).astype(np.dtype(uint).newbyteorder(bo)).tobytes()
        if compression == 5:
            return _lzw_encode(raw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        if compression == 32773:
            n = len(raw) // r
            return b"".join(_packbits(raw[k * n:(k + 1) * n]) for k in range(r))
        return raw

    if tile:
        tw, tl = tile
        ny, nx = -(-h // tl), -(-w // tw)
        pad = np.zeros((ny * tl, nx * tw, spp), samples.dtype)
        pad[:h, :w] = samples
        chunks = [encode(pad[y * tl:(y + 1) * tl, x * tw:(x + 1) * tw])
                  for y in range(ny) for x in range(nx)]
    else:
        rps = rows_per_strip or h
        chunks = [encode(samples[y:y + rps]) for y in range(0, h, rps)]
    fields = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [compression]),
              (262, 3, [photo]), (277, 3, [spp])]
    fields += [(338, 3, list(extra))] if extra else []
    fields += [(317, 3, [predictor])] if predictor != 1 else []
    fields += [(339, 3, [fmt] * spp)] if fmt else []
    data_at = 4096 + 16 * len(chunks)
    offsets = list(data_at + np.cumsum([0] + [len(c) for c in chunks[:-1]]))
    counts = [len(c) for c in chunks]
    if tile:
        fields += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, offsets), (325, 4, counts)]
    else:
        fields += [(273, 4, offsets), (278, 4, [rows_per_strip or h]), (279, 4, counts)]
    out = bytearray((b"II*\x00" if bo == "<" else b"MM\x00*") + struct.pack(bo + "I", 8))
    out += struct.pack(bo + "H", len(fields))
    spill, spill_at = bytearray(), 8 + 2 + 12 * len(fields) + 4
    for tag, typ, vals in sorted(fields):
        payload = struct.pack(bo + ("H" if typ == 3 else "I") * len(vals), *map(int, vals))
        out += struct.pack(bo + "HHI", tag, typ, len(vals))
        if len(payload) <= 4:
            out += payload.ljust(4, b"\0")
        else:
            out += struct.pack(bo + "I", spill_at + len(spill))
            spill += payload
    out += b"\0\0\0\0" + spill
    return bytes(out.ljust(data_at, b"\0")) + b"".join(chunks)


TIFF_LAYOUTS = [(1, np.uint8, 1, ()), (0, np.uint8, 1, ()), (1, np.uint16, 1, ()),
                (0, np.uint16, 1, ()), (1, np.float32, 1, ()), (0, np.float32, 1, ()),
                (1, np.uint8, 2, (2,)), (2, np.uint8, 3, ()), (2, np.uint16, 3, ()),
                (2, np.uint8, 4, ()), (2, np.uint8, 4, (0,)), (2, np.uint8, 4, (1,)),
                (2, np.uint8, 4, (2,)), (2, np.uint16, 4, (2,)), (2, np.uint16, 4, (1,)),
                (2, np.uint16, 4, (0,))]


@pytest.mark.parametrize("layout", range(len(TIFF_LAYOUTS)))
def test_tiff_decoder_matches_pillow(layout):
    """Every compression and predictor, byte order and organisation: both
    packages decode to the same array, or both reject the file (a
    big-endian 16-bit WhiteIsZero image: Pillow has no mode for it)."""
    photo, dt, spp, extra = TIFF_LAYOUTS[layout]
    rng = np.random.default_rng(layout)
    for comp in (1, 5, 8, 32946, 32773):
        for pred in (1, 2, 3):
            if (pred == 3 and dt != np.float32) or (pred != 1 and comp in (1, 32773)):
                continue
            for bo in "<>":
                for org in ({}, {"rows_per_strip": int(rng.integers(1, 8))},
                            {"tile": (16, 16)}):
                    h, w = (int(x) for x in rng.integers(1, 40, 2))
                    if dt == np.float32:
                        s = rng.standard_normal((h, w, spp)).astype(np.float32)
                    else:
                        s = np.cumsum(rng.integers(0, 9, (h, w, spp)), axis=1).astype(dt)
                    data = write_tiff(s, photo, extra, bo, comp, pred,
                                      fmt=3 if dt == np.float32 else None, **org)
                    if (photo, dt, bo) == (0, np.uint16, ">"):
                        for lib in (imgio, jimgio):
                            with pytest.raises(ValueError):
                                lib.load_image(data)
                        continue
                    got = check(data)
                    if dt == np.float32 and not (bo == ">" and comp != 1):
                        np.testing.assert_array_equal(got[..., 0], s[..., 0])


def test_tiff_pillow_files():
    """Pillow's own TIFFs: LZW, Deflate and PackBits, RGB, RGBA, L, LA,
    I;16 and F, with predictor 2 where libtiff takes it."""
    rng = np.random.default_rng(9)
    for h, w in SIZES:
        for chans in (1, 2, 3, 4):
            img = mf.texture(h, w, chans, h + w)
            for comp in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits"):
                kw = {"compression": comp} if comp else {}
                if comp in ("tiff_lzw", "tiff_adobe_deflate") and chans != 2:
                    kw["tiffinfo"] = {317: 2}
                check(mf.pillow(img, "TIFF", **kw))
        buf = io.BytesIO()
        Image.frombytes("I;16", (w, h), rng.integers(0, 65536, (h, w)).astype("<u2")
                        .tobytes()).save(buf, "TIFF", compression="tiff_lzw")
        check(buf.getvalue())


# ---------------------------------------------------------------------------
# 3. writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext", [".tga", ".tif", ".tiff", ".jpg", ".jpeg"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_writers_read_back_by_pillow(tmp_path, ext, channels):
    rng = np.random.default_rng(channels)
    # the JAX writer squeezes a grey image, so grey sizes keep both sides above 1
    for k, (h, w) in enumerate(s for s in SIZES if channels > 1 or min(s) > 1):
        img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8) if k % 2 else \
            mf.texture(h, w, channels, k)
        path = tmp_path / f"x{ext}"
        imgio.write_image_file(path, img)
        ref = tmp_path / f"ref{ext}"
        jimgio.write_image_file(ref, img)
        with Image.open(path) as a, Image.open(ref) as b:
            got, want = np.asarray(a), np.asarray(b)
        if ext in (".tga", ".tif", ".tiff"):
            np.testing.assert_array_equal(got, img.squeeze(-1) if channels == 1 else img)
        np.testing.assert_array_equal(got, want)  # a JPEG: the same decode, no tolerance
        assert same(imgio.load_image_file(path), jimgio.load_image_file(path).data)
    floats = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    imgio.write_image_file(tmp_path / f"f{ext}", floats)
    jimgio.write_image_file(tmp_path / f"g{ext}", floats)
    assert same(imgio.load_image_file(tmp_path / f"f{ext}"),
                jimgio.load_image_file(tmp_path / f"g{ext}").data)


# ---------------------------------------------------------------------------
# 4. what raises
# ---------------------------------------------------------------------------

def _jpeg_with_sof(marker: int, precision: int = 8, comps: int = 3) -> bytes:
    sof = struct.pack(">BHHB", precision, 8, 8, comps) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(comps))
    return b"\xff\xd8" + bytes([0xFF, marker]) + struct.pack(">H", len(sof) + 2) + sof + b"\xff\xd9"


def _unported() -> dict[str, bytes]:
    """Files the JAX package decodes in variants the port does not read yet
    (ROADMAP Queue 1 item 2). BMP, GIF, CMYK JPEG, 16-bit TGA and palette,
    CMYK and JPEG-compressed TIFF left this list when the port came to
    read them (tests/test_torch_imgio_formats.py), WebP too
    (tests/test_torch_webp.py), and 12-bit JPEG, which Pillow refuses
    (ValueError in both packages)."""
    rgb = mf.texture(16, 16, 3, 1)
    out = {f"jpeg_sof{m - 0xC0}": _jpeg_with_sof(m) for m in (0xC3, 0xC9, 0xCA, 0xCB)}
    for fmt in ("JPEG2000", "PCX", "SGI", "AVIF"):
        out[fmt.lower()] = mf.pillow(rgb, fmt)
    out["tiff_ycbcr_lzw"] = _tiff_ycbcr(rgb)
    return out


def _tiff_ycbcr(rgb: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("YCbCr").save(buf, "TIFF", compression="tiff_lzw")
    return buf.getvalue()


# the variants of _unported() the port has come to read (JPEG 2000, JPEG's
# lossless and arithmetic frames, YCbCr TIFF, PCX and SGI;
# tests/test_torch_jpeg2000.py, test_torch_jpeg_arith.py,
# test_torch_tiff_codecs.py and test_torch_imgio_legacy.py hold them in full)
NOW_PORTED = ("jpeg2000", "jpeg_sof3", "jpeg_sof9", "jpeg_sof10", "jpeg_sof11", "tiff_ycbcr_lzw",
              "pcx", "sgi")


@pytest.mark.parametrize("name", sorted(_unported()))
def test_unported_variants_raise(name):
    """A variant JAX reads (or rejects) that the port does not read raises
    NotImplementedError naming the ROADMAP item: the port never renders
    something else where the JAX package renders the image. A variant the
    port has come to read meets the contract: the JAX package's array, or
    ValueError in both."""
    data = _unported()[name]
    if name in NOW_PORTED:
        try:
            want = jimgio.load_image(data).data
        except ValueError:
            with pytest.raises(ValueError):
                imgio.load_image(data)
            return
        assert same(imgio.load_image(data), want)
        return
    with pytest.raises(NotImplementedError, match="USD content"):
        imgio.load_image(data)


BAD = {"empty": b"", "text": b"hello, world", "png_cut": None, "jpeg_cut": None,
       "tiff_cut": None, "tga_cut": None}


def _bad(name: str) -> bytes:
    full = {"png_cut": "png_interlaced.png", "jpeg_cut": "jpeg_420.jpg",
            "tiff_cut": "tiff_lzw_pred2.tif", "tga_cut": "tga_raw.tga"}
    if name in full:
        with open(os.path.join(FIXTURES, full[name]), "rb") as f:
            data = f.read()
        return data[:len(data) // 2]
    return BAD[name]


@pytest.mark.parametrize("name", sorted(BAD))
def test_undecodable_bytes_raise_value_error(name):
    data = _bad(name)
    with pytest.raises(ValueError):
        jimgio.load_image(data)
    with pytest.raises(ValueError):
        imgio.load_image(data)


def test_undecodable_texture_renders_black_and_logs(tmp_path):
    """A texture file no decoder accepts: both packages' pools hold the 1x1
    black fallback, and both log an error naming the file."""
    path = tmp_path / "broken.jpg"
    path.write_bytes(_bad("jpeg_cut"))
    good = tmp_path / "good.tga"
    imgio.write_image_file(good, mf.texture(5, 6, 3, 2))

    class Errors(logging.Handler):
        def __init__(self):
            super().__init__(logging.ERROR)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    pools = []
    for lib in (jtex, ttex):
        errors = Errors()
        logger = logging.getLogger("gatling")
        logger.addHandler(errors)
        try:
            refs = [lib.TextureRef(file_path=str(path)), lib.TextureRef(file_path=str(good))]
            pools.append(lib.TextureManager().build_pool(refs))
        finally:
            logger.removeHandler(errors)
        assert any(str(path) in m for m in errors.messages), errors.messages
    jp, tp = pools
    for name in ttex.TexturePool._fields:
        ref, got = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        if ref.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert int(tp.width[0]) == 1 and int(tp.height[0]) == 1
