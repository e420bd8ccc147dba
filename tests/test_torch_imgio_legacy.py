"""The port's decoders of Pillow's legacy plugins (imgio/sgi.py, pcx.py,
blp.py, ftex.py, sun.py, icns.py, fits.py, im.py, xpm.py, msp.py, fli.py,
pcd.py, rawformats.py and the native run-length loops of
csrc/legacy_codecs.cpp) against the JAX package's imgio (Pillow 12.1).

1. A corpus written by Pillow inside the test from a numpy seed: SGI, PCX,
   IM, ICNS, SPIDER, BLP, XBM and MSP in every mode each saver takes, at a
   few sizes: the port's array equals the JAX package's bit for bit
   wherever the JAX package decodes, and both raise ValueError elsewhere.
2. Hand-made files of what Pillow does not write (tests/data/imgio/
   make_fixtures.py): SGI RLE of 1-4 channels at 8 and 16 bits and its
   quirks, PCX bit planes and VGA palettes, DCX, BLP1 JPEG and palette,
   BLP2 palette and DXT1/3/5 with and without alpha, FTEX, every Sun
   raster depth and type, ICNS RLE icons with and without masks, FITS of
   every BITPIX and GZIP_1, FLI chunks, XPM, MSP 2, GBR, IMT, IPTC,
   MCIDAS, PIXAR, XVTHUMB and Photo CD in each orientation.
3. Each of those cut short at ten places and with bytes changed at ten
   seeds: the same array or ValueError in both (test_torch_imgio_formats's
   contract, no NotImplementedError: every format here is ported).
4. Through TextureManager: a pool of the new formats is the JAX
   manager's.
"""

import importlib.util
import io
import os

import numpy as np
import pytest
from PIL import Image

from gatling_tpu import imgio as jimgio
from gatling_tpu.render import texture as jtex

from gatling_tpu_torch import imgio
from gatling_tpu_torch.imgio import identify, pcd
from gatling_tpu_torch.render import texture as ttex

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_fixtures", os.path.join(HERE, "data", "imgio", "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)


def same(got: np.ndarray, want: np.ndarray) -> bool:
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    return np.array_equal(got, want) if got.dtype == bool else got.tobytes() == want.tobytes()


def contract(data: bytes) -> str:
    """'array' where both packages decode to the same array, 'rejected'
    where both raise ValueError; anything else fails."""
    try:
        want = jimgio.load_image(data).data
    except ValueError:
        with pytest.raises(ValueError):
            imgio.load_image(data)
        return "rejected"
    got = imgio.load_image(data)
    assert same(got, want), (got.dtype, want.dtype, got.shape, want.shape)
    return "array"


# ---------------------------------------------------------------------------
# 1. Pillow's savers
# ---------------------------------------------------------------------------

MODES = ("1", "L", "LA", "P", "PA", "RGB", "RGBA", "RGBX", "CMYK", "YCbCr", "I", "I;16",
         "I;16L", "I;16B", "F")
SAVERS = {"SGI": {}, "SGI-16": {"bpc": 2}, "PCX": {}, "IM": {}, "ICNS": {}, "SPIDER": {},
          "BLP": {}, "BLP-1": {"blp_version": "BLP1"}, "XBM": {}, "MSP": {}}
# IM types the port leaves to a later PR: YCC images (Pillow's own YCbCr
# tables) raise NotImplementedError naming ROADMAP Queue 1
IM_UNPORTED = ("YCbCr",)


@pytest.mark.parametrize("saver", sorted(SAVERS))
def test_pillow_corpus(saver):
    fmt = saver.split("-")[0]
    rng = np.random.default_rng(sorted(SAVERS).index(saver))
    # every ICNS Pillow writes holds a 1024^2 PNG: one size, four modes
    sizes = ((16, 16),) if fmt == "ICNS" else ((1, 1), (5, 3), (17, 23), (32, 40))
    modes = ("L", "P", "RGB", "RGBA") if fmt == "ICNS" else MODES
    written = decoded = 0
    for h, w in sizes:
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        img[..., 3] = rng.choice([0, 7, 128, 255], (h, w))
        for mode in modes:
            im = (Image.frombytes(mode, (w, h), (img[..., 0].astype("<u2") * 257).tobytes())
                  if mode.startswith("I;16") else Image.fromarray(img).convert(mode))
            buf = io.BytesIO()
            try:
                im.save(buf, fmt, **SAVERS[saver])
            except (OSError, ValueError, KeyError, TypeError):
                continue  # a mode this saver does not take
            written += 1
            if fmt == "IM" and mode in IM_UNPORTED:
                with pytest.raises(NotImplementedError, match="USD content"):
                    imgio.load_image(buf.getvalue())
                continue
            decoded += contract(buf.getvalue()) == "array"
    assert written and decoded


# ---------------------------------------------------------------------------
# 2. hand-made files
# ---------------------------------------------------------------------------

W, H = pcd.W, pcd.H


def pcd_file(seed: int, orientation: int) -> bytes:
    """A Photo CD of random PhotoYCC (the base image at sector 96)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (H, W), np.uint8)
    c1, c2 = (rng.integers(0, 256, (H // 2, W // 2), np.uint8) for _ in range(2))
    head = bytearray(pcd.OFFSET)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    body = b"".join(y[r].tobytes() + y[r + 1].tobytes() + c1[r // 2].tobytes()
                    + c2[r // 2].tobytes() for r in range(0, H, 2))
    return bytes(head) + body


def _chunks(enc: bytes) -> int:
    """The chunks of an 8-bit SGI RLE row before its terminator."""
    n = at = 0
    while enc[at] & 0x7F:
        at += 1 + ((enc[at] & 0x7F) if enc[at] & 0x80 else 1)
        n += 1
    return n


def _sgi_quirks(tex: np.ndarray) -> dict:
    """SGI RLE rows Pillow reads its own way: rows that end early (the last
    row's samples stay past them), and a row whose length, which Pillow
    takes as a count of chunks, ends it on a chunk that is no terminator
    (the decode stops there: the rows above stay 0)."""
    def early(r, c, enc):
        return bytes([0x85]) + enc[1:6] + b"\0" if r % 3 == 1 else enc

    seen = {}

    def unterminated(r, c, enc):
        if (r, c) == (7, 1):
            seen["chunks"] = _chunks(enc)
            return enc[:-1]
        return enc

    data = bytearray(mf.sgi_file(tex[..., :3], rows=unterminated))
    h = tex.shape[0]
    at = 512 + 4 * 3 * h + 4 * (7 + h)  # row 7, channel 1 in the length table
    data[at:at + 4] = seen["chunks"].to_bytes(4, "big")
    return {"sgi_early_rows": mf.sgi_file(tex[..., :3], rows=early),
            "sgi_unterminated": bytes(data)}


def hand_made() -> dict[str, bytes]:
    rng = np.random.default_rng(5)
    files = {}
    tex = mf.texture(21, 30, 4, 3)
    for c in (1, 3, 4):
        files[f"sgi_rle_c{c}"] = mf.sgi_file(tex[..., :c])
        files[f"sgi_rle16_c{c}"] = mf.sgi_file(tex[..., :c].astype(np.uint16) * 257 + 3, bpc=2)
        files[f"sgi_raw16_c{c}"] = mf.sgi_file(tex[..., :c].astype(np.uint16) * 255, bpc=2,
                                               rle=False)
    files["sgi_dim1"] = mf.sgi_file(tex[..., :1], dimension=1)
    files.update(_sgi_quirks(tex))
    g = tex[..., 0] > 128
    files["pcx_1b2p"] = mf.pcx_file(np.stack([g, tex[..., 1] > 100]), 1, bytes(range(48)))
    four = np.stack([tex[..., k] > 90 + 20 * k for k in range(4)])
    files["pcx_1b4p"] = mf.pcx_file(four, 1, bytes(range(48, 96)))
    files["pcx_1b4p_stride5"] = mf.pcx_file(four, 1, bytes(range(48, 96)), stride=5)
    files["pcx_1b1p"] = mf.pcx_file(g[None], 1)
    files["pcx_vga"] = mf.pcx_file(tex[None, ..., 0], 8,
                                   vga=rng.integers(0, 256, 768, np.uint8).tobytes())
    files["pcx_grey_vga"] = mf.pcx_file(tex[None, ..., 0], 8,
                                        vga=np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes())
    files["pcx_rgb_pad"] = mf.pcx_file(tex[..., :3].transpose(2, 0, 1), 8, stride=31)
    files["dcx"] = mf.dcx_file([mf.pcx_file(tex[..., :3].transpose(2, 0, 1), 8),
                                mf.pcx_file(g[None], 1)])
    t16 = mf.texture(16, 20, 3, 4)
    blocks = mf.dxt1_blocks(t16)
    pal = rng.integers(0, 256, (256, 4), np.uint8).tobytes()
    for ae in (0, 1, 7):
        for alpha in (0, 8):
            body = blocks if ae == 0 else rng.integers(0, 256, 20 * 16, np.uint8).tobytes()
            files[f"blp2_dxt{ae}_a{alpha}"] = mf.blp_file(2, 20, 16, body, 1, 2, alpha, ae, pal)
            files[f"blp2_dxt{ae}_a{alpha}_18x15"] = mf.blp_file(2, 18, 15, body, 1, 2, alpha, ae,
                                                                pal)
    for alpha in (0, 1, 4, 8):
        files[f"blp2_pal_a{alpha}"] = mf.blp_file(
            2, 20, 16, rng.integers(0, 256, 320, np.uint8).tobytes(), 1, 1, alpha, alpha, pal)
    files["blp2_raw_bgra"] = mf.blp_file(2, 4, 4, bytes(64), 1, 3, 8, 8, pal)
    for jname, jpg in (("rgb", mf.pillow(mf.texture(16, 20, 3, 7), "JPEG")),
                       ("grey", mf.pillow(mf.texture(16, 20, 1, 8), "JPEG")),
                       ("cmyk", _cmyk_jpeg(mf.texture(16, 20, 4, 9))),
                       ("big", mf.pillow(mf.texture(24, 28, 3, 10), "JPEG"))):
        k = jpg.find(b"\xff\xda")
        for alpha in (0, 8):
            files[f"blp1_jpeg_{jname}_a{alpha}"] = mf.blp_file(1, 20, 16, jpg[k:], 0, 5, alpha,
                                                               jpeg_header=jpg[:k])
    files["blp1_pal"] = mf.blp_file(1, 20, 16, rng.integers(0, 256, 320, np.uint8).tobytes(), 1,
                                    4, 8, palette=pal)
    files["ftex_dxt1"] = mf.ftex_file(20, 16, 0, blocks)
    files["ftex_raw"] = mf.ftex_file(20, 16, 1, t16.tobytes())
    grey = tex[..., 0]
    for depth in (1, 4, 8, 24, 32):
        if depth == 1:
            rows = np.packbits(grey > 128, axis=1)
        elif depth == 4:
            v = grey >> 4
            rows = np.packbits(((v[..., None] >> np.arange(3, -1, -1)) & 1).reshape(21, -1)
                               .astype(np.uint8), axis=1)
        elif depth == 8:
            rows = grey.copy()
        else:
            rows = tex[..., :depth // 8].reshape(21, -1)
        for ft in (1, 2, 3):
            files[f"sun_{depth}_t{ft}"] = mf.sun_file(rows, 30, depth, ft)
            if depth in (1, 4, 8):
                n = 16 if depth == 4 else 2 if depth == 1 else 200
                files[f"sun_{depth}_t{ft}_pal"] = mf.sun_file(
                    rows, 30, depth, ft, rng.integers(0, 256, (n, 3), np.uint8))
    for kind, side, mk in ((b"is32", 16, b"s8mk"), (b"il32", 32, b"l8mk"), (b"ih32", 48, b"h8mk"),
                           (b"it32", 128, b"t8mk")):
        icon = mf.texture(side, side, 4, side)
        rgb = mf.icns_rgb(icon[..., :3], kind)
        files[f"icns_{kind.decode()}"] = mf.icns_file([(kind, rgb), (mk, icon[..., 3].tobytes())])
        files[f"icns_{kind.decode()}_nomask"] = mf.icns_file([(kind, rgb)])
    icon = mf.texture(16, 16, 4, 9)
    files["icns_raw"] = mf.icns_file([(b"is32", mf.icns_rgb(icon[..., :3], b"is32", rle=False))])
    files["icns_png_and_rle"] = mf.icns_file([
        (b"is32", mf.icns_rgb(icon[..., :3], b"is32")),
        (b"ic07", mf.pillow(mf.texture(128, 128, 4, 10), "PNG"))])
    arr = mf.texture(13, 17, 1, 11)[..., 0].astype(np.int64)
    for bp in (8, 16, 32, -32, -64):
        files[f"fits_{bp}"] = mf.fits_file(arr * (1 if bp == 8 else 37) - (0 if bp == 8 else 1000),
                                           bp)
    files["fits_naxis1"] = mf.fits_file(arr[:1], 8).replace(b"NAXIS   =                    2",
                                                            b"NAXIS   =                    1")
    for zb in (8, 16, 32):
        files[f"fits_gz{zb}"] = mf.fits_gzip(arr * (1 if zb == 8 else 37), zb)
    files["fits_gz_neg"] = mf.fits_gzip(arr, -32)
    idx = (tex[..., 0] // 32).astype(np.uint8)
    files["fli_brun"] = mf.fli_file(30, 21, [(11, mf.fli_color(rng.integers(0, 64, (256, 3)))),
                                             (15, mf.fli_brun(idx))])
    files["fli_copy"] = mf.fli_file(30, 21, [(4, mf.fli_color(rng.integers(0, 256, (8, 3)), 3)),
                                             (16, idx.tobytes())], flc=False)
    files["fli_lc"] = mf.fli_file(30, 21, [(15, mf.fli_brun(idx)), (12, mf.fli_lc(
        3, [[(2, b"abc"), (1, (4, 7))], [], [(0, b"z")]]))])
    files["fli_ss2"] = mf.fli_file(30, 21, [(13, b""), (7, mf.fli_ss2(
        [([0xFFFE], [(2, b"abcd"), (3, (2, b"xy"))]), ([0x8041], [(0, b"qr")])])),
        (18, b"stamp!")])
    files["fli_short_tail"] = mf.fli_file(30, 21, [(15, mf.fli_brun(idx)), (18, b"st")])
    files["fli_prefix"] = mf.fli_file(30, 21, [(15, mf.fli_brun(idx))], prefix=b"\0" * 10)
    colours = [b"#%06x" % int(v) for v in rng.integers(0, 1 << 24, 300)]
    files["xpm_p"] = mf.xpm_file(idx, colours[:8])
    files["xpm_cpp2"] = mf.xpm_file(idx, colours[8:16], cpp=2, pixels_comment=False)
    files["xpm_none_unused"] = mf.xpm_file(idx % 7, colours[:7] + [b"None"])
    files["xpm_none_used"] = mf.xpm_file(idx, colours[:7] + [b"None"])
    files["xpm_named"] = mf.xpm_file(idx % 2, [b"red", b"#000000"])
    files["xpm_rgb"] = mf.xpm_file((tex[..., 0].astype(np.int64) + tex[..., 1]) % 300, colours,
                                   cpp=2)
    files["xbm_hotspot"] = mf.pillow(g, "XBM", hotspot=(3, 4))
    files["msp1"] = mf.msp_file(g, 1)
    files["msp2"] = mf.msp_file(g, 2)
    files["msp2_blank"] = mf.msp_file(np.concatenate([g[:5], np.ones((3, 30), bool), g[8:]]), 2)
    files["gbr1"] = mf.gbr_file(tex[..., :1], 1)
    files["gbr2"] = mf.gbr_file(tex[..., :1], 2)
    files["gbr2_rgba"] = mf.gbr_file(tex, 2)
    files["imt"] = mf.imt_file(grey)
    files["iptc_l"] = mf.iptc_file(grey)
    files["iptc_rgb_band3"] = mf.iptc_file(grey, band=3, layers=3, component=1)
    files["iptc_rgb_band4"] = mf.iptc_file(grey, band=4, layers=3, component=1)
    files["iptc_rgb_band0"] = mf.iptc_file(grey, band=0, layers=3, component=1)
    files["iptc_cmyk_band0"] = mf.iptc_file(grey, band=0, layers=4, component=1)
    files["mcidas_1"] = mf.mcidas_file(grey, 1, 4)
    files["mcidas_2"] = mf.mcidas_file(grey.astype(np.int64) * 200, 2)
    files["mcidas_4"] = mf.mcidas_file(grey.astype(np.int64) * 70000 - 5000000, 4, 8)
    files["pixar"] = mf.pixar_file(tex[..., :3])
    files["xvthumb"] = mf.xvthumb_file(tex[..., 0])
    spider = io.BytesIO()
    Image.fromarray(grey.astype(np.float32) / 7.0 - 3.0, "F").save(spider, "SPIDER")
    files["spider_le"] = spider.getvalue()
    files["spider_be"] = _spider_big_endian(spider.getvalue())
    for orientation in range(4):
        files[f"pcd_o{orientation}"] = pcd_file(orientation, orientation)
    return files


def _cmyk_jpeg(tex: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.frombytes("CMYK", tex.shape[1::-1], tex.tobytes()).save(buf, "JPEG")
    return buf.getvalue()


def _spider_big_endian(le: bytes) -> bytes:
    """Pillow's SPIDER file with every float byte-swapped."""
    return np.frombuffer(le, "<f4").astype(">f4").tobytes()


HAND_MADE = hand_made()
# Pillow gives these up too: a run across PCX rows (planes at a stride Pillow
# does not trust), a frame after an FLI prefix chunk, an FLI subchunk of
# fewer than 10 bytes at the frame's end, a BLP2 of raw BGRA
# (no decoder), an XPM pixel of the transparent "None" key, an XPM colour
# name, an RGB IPTC image naming a band past its three, GZIP_1 of a float
# BITPIX, a 1-bit Sun raster with a palette (a "1" image takes none)
REJECTED = ("pcx_1b4p_stride5", "fli_prefix", "fli_short_tail", "blp2_raw_bgra", "xpm_none_used", "xpm_named",
            "iptc_rgb_band4", "fits_gz_neg", "sun_1_t1_pal", "sun_1_t2_pal", "sun_1_t3_pal")


@pytest.mark.parametrize("name", sorted(HAND_MADE))
def test_hand_made(name):
    assert contract(HAND_MADE[name]) == ("rejected" if name in REJECTED else "array")


def test_sgi_row_quirks_show():
    """The quirk files differ from the plain encoding's image: the early
    rows keep the last row's samples, the unterminated list leaves rows 0."""
    tex = mf.texture(21, 30, 4, 3)
    plain = imgio.load_image(mf.sgi_file(tex[..., :3]))
    for name in ("sgi_early_rows", "sgi_unterminated"):
        got = imgio.load_image(HAND_MADE[name])
        assert not np.array_equal(got, plain)
    assert (imgio.load_image(HAND_MADE["sgi_unterminated"])[:14] == [0, 0, 0, 255]).all()


# ---------------------------------------------------------------------------
# 3. cut and damaged copies
# ---------------------------------------------------------------------------

def _variants(data: bytes, seed: int):
    rng = np.random.default_rng(seed)
    for frac in np.linspace(0.05, 0.98, 10):
        yield data[:int(len(data) * frac)]
    for _ in range(10):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        yield bytes(b)


FAMILIES = sorted({name.split("_")[0] for name in HAND_MADE})


@pytest.mark.parametrize("family", FAMILIES)
def test_damaged_copies(family):
    seen = set()
    for name in sorted(HAND_MADE):
        if name.split("_")[0] != family or name.startswith("pcd"):
            continue
        for blob in _variants(HAND_MADE[name], sorted(HAND_MADE).index(name)):
            seen.add(contract(blob))
    if family != "pcd":
        assert "rejected" in seen


def test_pcd_cut_and_damaged():
    """Photo CD: cut inside its image (both raise), its orientation byte
    changed (the rotation follows), its header's magic changed (no plugin
    takes it)."""
    data = HAND_MADE["pcd_o0"]
    assert contract(data[:len(data) - 1]) == "rejected"
    b = bytearray(data)
    b[2048 + 1538] = 7  # orientation 3
    assert contract(bytes(b)) == "array"
    b[2048] = ord("X")
    assert contract(bytes(b)) == "rejected"


def test_pcd_ycc_tables():
    """pcd.py's compact tables rebuild Pillow's libImaging/UnpackYCC.c: 256
    entries each, its opening entries, and each chroma table 0 at its
    neutral code (137 for CR and GR, 156 for CB and GB). The decodes of
    test_hand_made pin L, CR, CB and GR + GB entry by entry."""
    t = pcd.ycc_tables()
    opening = {"L": [0, 1, 3, 4, 5, 7, 8, 10, 11, 12, 14], "CR": [-249, -247, -245],
               "CB": [-345, -343, -341, -338], "GR": [127, 126, 125, 124, 123, 122, 121, 121, 120],
               "GB": [67, 67, 66, 66, 65, 65, 65, 64, 64, 63]}
    for name, first in opening.items():
        assert t[name].shape == (256,) and t[name][:len(first)].tolist() == first, name
    assert t["CR"][137] == t["GR"][137] == 0 and t["CB"][156] == t["GB"][156] == 0


def test_every_pillow_format_but_avif_is_ported():
    """identify.UNPORTED_OPEN holds AVIF and the formats Pillow cannot load
    here, nothing else."""
    assert set(identify.UNPORTED_OPEN) == {"AVIF", "EPS", "WMF", "BUFR", "GRIB", "HDF5", "MPEG"}


# ---------------------------------------------------------------------------
# 4. the texture manager
# ---------------------------------------------------------------------------

def test_texture_manager_pools_match(tmp_path):
    """8-bit and float textures of the new formats through both managers:
    the same pool (a float pool: FITS and SPIDER)."""
    names = ["sgi_rle_c3", "pcx_vga", "dcx", "blp2_dxt0_a8", "blp1_jpeg_rgb_a0", "ftex_dxt1",
             "sun_8_t2_pal", "icns_it32", "xpm_p", "msp2", "fli_brun", "gbr2_rgba", "xvthumb",
             "fits_-32", "spider_le", "mcidas_2"]
    paths = []
    for name in names:
        path = tmp_path / f"{name}.tex"
        path.write_bytes(HAND_MADE[name])
        paths.append(str(path))
    pools = [lib.TextureManager().build_pool([lib.TextureRef(file_path=p) for p in paths])
             for lib in (jtex, ttex)]
    jp, tp = pools
    for field in ttex.TexturePool._fields:
        ref, got = np.asarray(getattr(jp, field)), getattr(tp, field).numpy()
        if ref.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, ref, err_msg=field)
    assert (tp.width.numpy()[:len(names)] > 1).all()
    assert not tp.packed
