"""The port's JPEG 2000 decoder (imgio/jpeg2000.py and the native
csrc/jpeg2000.cpp) against the JAX package's imgio (Pillow 12.1 over
OpenJPEG 2.5.4), code for code.

1. A seeded corpus from Pillow's saver over its options: both
   transforms, MCT on and off, JP2 and raw codestreams, all five
   progression orders, one to six resolutions, code-blocks from 4x4 to
   64x64 and non-square ones, precincts, tiles with tile and image
   offsets, quality layers by rate and by dB, PLT markers, comments,
   signed samples, one to four components of 8 and 16 bits, sizes such as
   1x17, 17x1 and 3x5: each file decodes in the port to the JAX package's
   array (dtype, shape, every value).
2. Hand-made JP2 boxes: pclr with and without cmap (Pillow's palette,
   OpenJPEG never applies it in Pillow's tile-by-tile decoding), a cdef
   reorder (likewise not applied), colr sYCC and CMYK, unknown and ICC
   colour specifications, a res box, no jp2c, a truncated codestream, no
   EOC, a size that disagrees with SIZ: the same array, or ValueError in
   both packages.
3. Subsampled components (SIZ's XRsiz and YRsiz set on saved files),
   which Pillow reads at w / dx and h / dy and, with no colour space
   given, takes for sYCC when a chroma component is subsampled.
4. Seeded damage: two bytes changed past the main header of a JP2 file
   and of a tiled raw codestream, and of section 6's SOP/EPH, PPT, PPM and
   all-styles codestreams, 60 seeds each. OpenJPEG's tolerated damage
   gives Pillow's array, its failures (Pillow's "broken data stream")
   ValueError.
5. The native inverse 5/3 and 9/7 wavelets and the inverse RCT and ICT
   against their NumPy twins (jpeg2000.idwt53_ref, idwt97_ref, mct_ref),
   bit for bit, odd sizes and offsets included.
6. What Pillow's saver cannot write, from OpenJPEG's own encoder
   (tests/data/jpeg2000/make_openjpeg_files.py, the committed files):
   every code-block style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM and
   mixes) with both wavelets and three layers, POC, SOP and EPH markers
   with precincts, RGN shifts, several tile-parts a tile, and the same
   packets with their headers in PPT or PPM markers.

7. Header orders OpenJPEG settles (tests/data/jpeg2000/repairs/): a COD or
   QCD after a COC or QCC, a tile-part of Psot 12, a repeated tile-part 0
   of 0.

High-throughput blocks (HTJ2K) and the Part 2 markers are
tests/test_torch_htj2k.py's.
"""

import importlib.util
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from gatling_tpu import imgio as jimgio

from gatling_tpu_torch import imgio
from gatling_tpu_torch.imgio import jpeg2000

HERE = os.path.dirname(os.path.abspath(__file__))
OPENJPEG_FILES = os.path.join(HERE, "data", "jpeg2000")
_spec = importlib.util.spec_from_file_location(
    "make_fixtures", os.path.join(HERE, "data", "imgio", "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)

PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def corpus() -> list:
    """(name, channels, bits, (h, w), Pillow's save options); every entry
    saves without tripping Pillow's encoder, which crashes on some (an
    image offset without a tile grid, LA with tiles)."""
    """(name, channels, bits, (h, w), options)"""
    out = []
    for prg in PROGRESSIONS:
        for irr in (False, True):
            for fmt in ("jp2", "j2k"):
                kw = dict(progression=prg, irreversible=irr, num_resolutions=3)
                if fmt == "j2k": kw["no_jp2"] = True
                out.append((f"{prg}_{'97' if irr else '53'}_{fmt}", 3, 8, (33, 41), kw))
    for n in range(1, 7):
        out.append((f"res{n}", 3, 8, (64, 64), dict(num_resolutions=n, irreversible=n % 2 == 0)))
    for cb in ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (16, 64), (64, 16), (4, 64), (128, 32), (8, 128)):
        out.append((f"cblk{cb[0]}x{cb[1]}", 3, 8, (48, 56), dict(codeblock_size=cb, num_resolutions=3)))
    for p, prg in (((16, 16), "RPCL"), ((32, 32), "PCRL"), ((64, 64), "CPRL"), ((128, 128), "LRCP"), ((32, 64), "RLCP")):
        out.append((f"prec{p[0]}x{p[1]}_{prg}", 3, 8, (70, 60), dict(precinct_size=p, progression=prg, num_resolutions=4, irreversible=True)))
    for ts, to, off in (((16, 16), None, None), ((24, 40), None, None), ((64, 64), None, None),
                        ((32, 32), (2, 3), (5, 7)), ((20, 24), (1, 1), (3, 2)), ((16, 48), (0, 4), (4, 6))):
        kw = dict(tile_size=ts, num_resolutions=2)
        if to: kw["tile_offset"] = to
        if off: kw["offset"] = off
        out.append((f"tile{ts[0]}x{ts[1]}{'_off' if off else ''}", 3, 8, (50, 62), kw))
    for mode, layers in (("rates", [40, 20, 10]), ("rates", [5]), ("dB", [30, 40]), ("dB", [50])):
        out.append((f"layers_{mode}_{len(layers)}", 3, 8, (40, 44), dict(quality_mode=mode, quality_layers=layers, irreversible=True)))
    out.append(("plt", 3, 8, (40, 44), dict(plt=True, num_resolutions=3)))
    out.append(("comment", 3, 8, (40, 44), dict(comment="a texture of the interior")))
    out.append(("signed", 3, 8, (40, 44), dict(signed=True)))
    out.append(("signed_97", 1, 8, (40, 44), dict(signed=True, irreversible=True)))
    for c, bits, kw in ((1, 8, {}), (2, 8, {}), (3, 8, dict(mct=0)), (3, 8, dict(mct=1)), (4, 8, {}),
                        (4, 8, dict(irreversible=True, mct=1)), (1, 16, {}), (1, 16, dict(irreversible=True)),
                        (1, 16, dict(signed=True))):
        out.append((f"c{c}_{bits}bit_{len(out)}", c, bits, (30, 38), kw))
    for (h, w) in ((1, 17), (17, 1), (3, 5), (5, 3), (1, 1), (2, 2), (9, 64)):
        out.append((f"size{h}x{w}", 3, 8, (h, w), dict(num_resolutions=1 if min(h, w) < 2 else 2)))
    out.append(("size1x17_grey", 1, 8, (1, 17), {}))
    return out


CORPUS = {entry[0]: entry for entry in corpus()}


def pil_image(arr: np.ndarray, channels: int, bits: int) -> Image.Image:
    if bits == 16:
        h, w = arr.shape[:2]
        return Image.frombytes("I;16", (w, h), arr[..., 0].astype("<u2").tobytes())
    if channels == 2:
        return Image.fromarray(arr, "LA")
    return Image.fromarray(arr[..., 0] if channels == 1 else arr)


def saved(name: str) -> bytes:
    _, channels, bits, (h, w), kw = CORPUS[name]
    arr = mf.texture(h, w, channels, list(CORPUS).index(name), depth=bits)
    buf = io.BytesIO()
    pil_image(arr, channels, bits).save(buf, "JPEG2000", **kw)
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
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape)
    diff = np.argwhere((got != want).reshape(got.shape[0], got.shape[1], -1).any(-1))
    assert not len(diff), (len(diff), diff[:3].tolist())
    return "array"


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_saved_file_decodes_as_jax(name):
    assert contract(saved(name)) == "array"


# ---------------------------------------------------------------------------
# 2. hand-made boxes
# ---------------------------------------------------------------------------

def _codestream(arr: np.ndarray, mode: str | None = None, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG2000", no_jp2=True, **kw)
    return buf.getvalue()


def _box(kind: bytes, payload: bytes) -> bytes:
    return mf.jp2_box(kind, payload)


def _pclr(entries: list, npc: int = 3, depth: int = 7) -> bytes:
    return _box(b"pclr", struct.pack(">HB", len(entries), npc) + bytes([depth] * npc)
                + b"".join(bytes(e) for e in entries))


def _cmap(npc: int = 3) -> bytes:
    return _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(npc)))


def _cdef(pairs: list) -> bytes:
    return _box(b"cdef", struct.pack(">H", len(pairs))
                + b"".join(struct.pack(">HHH", *p) for p in pairs))


def _jp2(cs: bytes, h: int, w: int, nc: int, colr=(1, 16), extra: bytes = b"",
         after: bytes = b"", codestream: bool = True, ihdr: bytes | None = None) -> bytes:
    head = ihdr if ihdr is not None else _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
    if colr is not None:
        head += _box(b"colr", struct.pack(">BBBI", colr[0], 0, 0, colr[1]))
    out = b"\x00\x00\x00\x0cjP  \r\n\x87\n" + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
    out += _box(b"jp2h", head + extra)
    return out + (_box(b"jp2c", cs) if codestream else b"") + after


def boxes() -> dict:
    rng = np.random.default_rng(0)
    grey = _codestream(rng.integers(0, 6, (9, 11)).astype(np.uint8))
    rgb = _codestream(mf.texture(9, 11, 3, 2), irreversible=True)
    rgba = _codestream(mf.texture(9, 11, 4, 3))
    la = _codestream(mf.texture(9, 11, 2, 4), "LA")
    pal = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 0, 0), (9, 9, 9)]
    return {
        "pclr": _jp2(grey, 9, 11, 1, extra=_pclr(pal) + _cmap()),
        "pclr_no_cmap": _jp2(grey, 9, 11, 1, extra=_pclr(pal)),
        "pclr_grey_colr": _jp2(grey, 9, 11, 1, colr=(1, 17), extra=_pclr(pal) + _cmap()),
        "pclr_rgba": _jp2(grey, 9, 11, 1, extra=_pclr([(1, 2, 3, 4), (5, 6, 7, 255),
                                                          (1, 2, 3, 4)], 4) + _cmap(4)),
        "pclr_one_column": _jp2(grey, 9, 11, 1, extra=_pclr([(7,), (8,), (9,), (10,)], 1)
                                + _cmap(1)),
        "pclr_deep": _jp2(grey, 9, 11, 1, extra=_pclr([(1, 2, 3)], 3, depth=11) + _cmap()),
        "pclr_empty": _jp2(grey, 9, 11, 1, extra=_pclr([]) + _cmap()),
        "pclr_la": _jp2(la, 9, 11, 2, extra=_pclr(pal) + _cmap()),
        "cmap_alone": _jp2(grey, 9, 11, 1, extra=_cmap()),
        "cdef_reorder": _jp2(rgba, 9, 11, 4, extra=_cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1),
                                                            (3, 1, 0)])),
        "cdef_empty": _jp2(rgba, 9, 11, 4, extra=_box(b"cdef", b"\0\0")),
        "cdef_rgb": _jp2(rgb, 9, 11, 3, extra=_cdef([(0, 0, 2), (1, 0, 1), (2, 0, 3)])),
        "colr_sycc": _jp2(rgb, 9, 11, 3, colr=(1, 18)),
        "colr_cmyk": _jp2(rgba, 9, 11, 4, colr=(1, 12)),
        "colr_cmyk_rgb": _jp2(rgb, 9, 11, 3, colr=(1, 12)),
        "colr_grey_rgba": _jp2(rgba, 9, 11, 4, colr=(1, 17)),
        "colr_esycc": _jp2(rgb, 9, 11, 3, colr=(1, 24)),
        "colr_cielab": _jp2(rgb, 9, 11, 3, colr=(1, 14)),
        "colr_unknown": _jp2(rgb, 9, 11, 3, colr=(1, 99)),
        "colr_icc": _jp2(rgb, 9, 11, 3, colr=(2, 0)),
        "colr_absent": _jp2(rgb, 9, 11, 3, colr=None),
        "colr_twice": _jp2(rgb, 9, 11, 3, extra=_box(b"colr", struct.pack(">BBBI", 1, 0, 0, 17))),
        "la": _jp2(la, 9, 11, 2, colr=(1, 17)),
        "bpcc": _jp2(rgb, 9, 11, 3, extra=_box(b"bpcc", bytes([7, 7, 7]))),
        "bpcc_short": _jp2(rgb, 9, 11, 3, extra=_box(b"bpcc", bytes([7, 7]))),
        "res": _jp2(rgb, 9, 11, 3, extra=_box(b"res ", _box(b"resc", struct.pack(
            ">HHHHBB", 1, 2, 3, 4, 0, 0)))),
        "res_short": _jp2(rgb, 9, 11, 3, extra=_box(b"res ", _box(b"resc", b"\0\1"))),
        "no_jp2c": _jp2(rgb, 9, 11, 3, codestream=False),
        "no_jp2c_xml": _jp2(rgb, 9, 11, 3, codestream=False, after=_box(b"xml ", b"<a/>")),
        "box_after_jp2c": _jp2(rgb, 9, 11, 3, after=_box(b"xml ", b"<a/>")),
        "truncated": _jp2(rgb, 9, 11, 3)[:-40],
        "no_eoc": _jp2(rgb[:-2], 9, 11, 3),
        "no_eoc_junk": _jp2(rgb[:-2] + b"\x12\x34", 9, 11, 3),
        "ihdr_size": _jp2(rgb, 9, 12, 3),
        "ihdr_components": _jp2(rgb, 9, 11, 4),
        "ihdr_length": _jp2(rgb, 9, 11, 3, ihdr=_box(b"ihdr", struct.pack(
            ">IIHBBBBB", 9, 11, 3, 7, 7, 0, 0, 0))),
        "codestream_tail": rgb + b"\0\0\0",
    }


BOXES = boxes()


@pytest.mark.parametrize("name", sorted(BOXES))
def test_handmade_boxes(name):
    contract(BOXES[name])


def test_palette_and_colour_spaces_decode():
    """The palette, sYCC and CMYK files give arrays (not both rejected)."""
    for name in ("pclr", "pclr_rgba", "colr_sycc", "colr_cmyk", "cdef_reorder"):
        assert contract(BOXES[name]) == "array", name


# ---------------------------------------------------------------------------
# 3. subsampled components
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", (3, 4))
def test_subsampled_components(channels):
    """XRsiz / YRsiz patched into saved codestreams: the first subsampled
    component decides Pillow's colour space, its samples are read at
    w / dx and h / dy, and MCT over components of different sizes fails."""
    seen = set()
    for (h, w) in ((9, 11), (16, 16), (17, 5)):
        for kw in ({}, {"irreversible": True}, {"tile_size": (8, 8)}, {"mct": 1}):
            data = _codestream(mf.texture(h, w, channels, 1), **kw)
            for comps, dx, dy in (((1, 2), 2, 2), ((2,), 1, 2), ((0,), 2, 1), ((3,), 2, 2),
                                  ((1, 2), 3, 1)):
                patched = bytearray(data)
                for k in comps:
                    if k < channels:
                        patched[4 + 38 + 3 * k + 1] = dx
                        patched[4 + 38 + 3 * k + 2] = dy
                seen.add(contract(bytes(patched)))
    assert seen == {"array", "rejected"}


# ---------------------------------------------------------------------------
# 4. seeded damage
# ---------------------------------------------------------------------------

DAMAGED = {"jp2": {"irreversible": True, "mct": 1, "num_resolutions": 3},
           "j2k_tiled": {"no_jp2": True, "tile_size": (16, 16), "progression": "RPCL",
                         "precinct_size": (16, 16), "num_resolutions": 3},
           # OpenJPEG's encoder (section 6): a missing SOP is a warning, a
           # missing EPH an error; PPT and PPM headers; every code-block style
           "sop_eph": "sop_eph_precincts.j2k", "ppt": "ppt.j2k", "ppm": "ppm.j2k",
           "styles": "style_all_97.j2k"}
SEEDS_PER_CASE = 15


def damage_source(kind: str) -> bytes:
    if isinstance(DAMAGED[kind], str):
        with open(os.path.join(OPENJPEG_FILES, DAMAGED[kind]), "rb") as f:
            return f.read()
    buf = io.BytesIO()
    Image.fromarray(mf.texture(40, 48, 3, 7)).save(buf, "JPEG2000", **DAMAGED[kind])
    return buf.getvalue()


@pytest.mark.parametrize("group", range(4))
@pytest.mark.parametrize("kind", sorted(DAMAGED))
def test_damage_meets_the_contract(kind, group):
    """Seeds 0-59 of each kind, fifteen a case: two bytes changed at
    positions drawn from past the main header."""
    data = damage_source(kind)
    lo = data.find(b"\xff\x90") + 2
    for seed in range(group * SEEDS_PER_CASE, (group + 1) * SEEDS_PER_CASE):
        rng = np.random.default_rng(seed)
        b = bytearray(data)
        for _ in range(2):
            b[int(rng.integers(lo, len(b)))] = int(rng.integers(0, 256))
        contract(bytes(b))


REPAIRS = os.path.join(OPENJPEG_FILES, "repairs")


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(REPAIRS) if f.endswith(".j2k")))
def test_header_orders_decode_as_openjpeg(name):
    """tests/data/jpeg2000/repairs/make_repairs.py: a COC or QCC before the
    COD or QCD (with the same parameters or others: the later COD or QCD
    overrides it, as in OpenJPEG), a tile-part of Psot 12 (no data), a
    repeated tile-part 0 of 0 (OpenJPEG fails on it)."""
    with open(os.path.join(REPAIRS, name), "rb") as f:
        data = f.read()
    want = "rejected" if name == "repeated_part0.j2k" else "array"
    assert contract(data) == want


def test_header_repairs_are_current():
    """make_repairs.py writes the committed files, byte for byte."""
    spec = importlib.util.spec_from_file_location("make_repairs",
                                                  os.path.join(REPAIRS, "make_repairs.py"))
    mr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mr)
    for name, data in mr.files().items():
        with open(os.path.join(REPAIRS, name), "rb") as f:
            assert f.read() == data, name


def test_high_throughput_blocks_raise_not_implemented():
    """An MQ-coded file with COD's HT code-block style set: OpenJPEG reads
    its blocks as HT blocks and fails on them, and so does the port (both
    raise ValueError). The HT files themselves are tests/test_torch_htj2k.py's."""
    data = bytearray(_codestream(mf.texture(16, 16, 3, 1)))
    cod = data.find(b"\xff\x52")
    data[cod + 12] |= 0x40
    assert contract(bytes(data)) == "rejected"


# ---------------------------------------------------------------------------
# 5. the native transforms against their twins
# ---------------------------------------------------------------------------

RECTS = ((0, 0, 17, 13, 4), (3, 1, 40, 22, 5), (1, 2, 2, 9, 2), (0, 0, 1, 7, 3), (5, 5, 64, 48, 6))


@pytest.mark.parametrize("reversible", (True, False))
def test_native_wavelets_match_twins(reversible):
    rng = np.random.default_rng(3)
    for x0, y0, x1, y1, numres in RECTS:
        rects = jpeg2000.resolution_rects(x0, y0, x1, y1, numres)
        shape = (y1 - y0, x1 - x0)
        if reversible:
            data = rng.integers(-300, 300, shape).astype(np.int32)
            twin = jpeg2000.idwt53_ref(data, rects)
        else:
            data = rng.normal(0, 80, shape).astype(np.float32)
            twin = jpeg2000.idwt97_ref(data, rects)
        got = jpeg2000.idwt(data, rects, reversible)
        assert got.dtype == twin.dtype and got.tobytes() == twin.tobytes(), (x0, y0, x1, y1)


@pytest.mark.parametrize("reversible", (True, False))
def test_native_mct_matches_twin(reversible):
    rng = np.random.default_rng(4)
    if reversible:
        planes = [rng.integers(-512, 512, 1001).astype(np.int32) for _ in range(3)]
    else:
        planes = [rng.normal(0, 90, 1001).astype(np.float32) for _ in range(3)]
    got = jpeg2000.mct(*planes, reversible)
    twin = jpeg2000.mct_ref(*planes, reversible)
    for g, t in zip(got, twin):
        assert g.dtype == t.dtype and g.tobytes() == t.tobytes()


# ---------------------------------------------------------------------------
# 6. OpenJPEG's encoder: code-block styles, POC, SOP/EPH, RGN, tile-parts,
# PPT and PPM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(f for f in os.listdir(OPENJPEG_FILES)
                                        if f.endswith(".j2k")))
def test_openjpeg_encoder_files_decode_as_jax(name):
    with open(os.path.join(OPENJPEG_FILES, name), "rb") as f:
        assert contract(f.read()) == "array"
