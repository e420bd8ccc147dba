"""The port's high-throughput JPEG 2000 decoding (HTJ2K, JPEG 2000 Part 15:
csrc/jpeg2000.cpp's ht_decode_cblk and its tier-2 branch) and the Part 2
and Part 15 marker segments (imgio/jpeg2000.py: MCT, MCC, MCO, CBD, CAP,
CPF) against the JAX package's imgio (Pillow 12.1 over OpenJPEG 2.5.4):
the same array, or ValueError in both.

1. The committed files of tests/data/jpeg2000/make_ht_files.py: HT
   cleanup-only and 3-pass blocks, cleanup bit-planes above 0, 64x64,
   32x32, 16x64 and 1024x4 code-blocks, odd edges, tiles, precincts,
   layers, RCT with the 5/3 and ICT with the 9/7, RGB, RGBA, 12- and
   16-bit and signed grey, raw, JP2 and JPH, and what OpenJPEG refuses
   (a refinement in a later layer than its cleanup, the mixed style,
   ROI); MCT/MCC/MCO/CBD/CAP/CPF spliced into Pillow-saved codestreams.
   ht_fixtures.npz, the arrays the card's host checks, holds the JAX
   package's decode of each.
2. The encoder against OpenJPEG: each reversible file decodes in Pillow
   to the image it meant (cleanup-only files to their input), and
   make_ht_files.py writes the committed bytes.
3. 2,000 random cleanup segments of valid lengths over block sizes from
   1x9 to 1024x4, one to four passes and bands of 8 to 26 bit-planes:
   malformed MEL, VLC, U_q, Scup and pass counts end as OpenJPEG ends
   them.
4. Seeded damage to each HT file past its SOD.
5. MQ-coded files with COD's HT style bit set (OpenJPEG reads their blocks
   as HT blocks), across code-block sizes and both wavelets.
6. A JP2 file whose brand is 'jph ' (or any other) decodes as JP2.
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
DATA = os.path.join(HERE, "data", "jpeg2000")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mh = _load("make_ht_files", os.path.join(DATA, "make_ht_files.py"))
mf = _load("make_fixtures", os.path.join(HERE, "data", "imgio", "make_fixtures.py"))
COMMITTED = sorted(f for f in os.listdir(DATA) if f.startswith(("ht_", "p2_"))
                   and not f.endswith(".npz"))
ARRAYS = np.load(os.path.join(DATA, "ht_fixtures.npz"))
REFUSED = set(ARRAYS["refused"].tolist())


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


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# 1. the committed files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", COMMITTED)
def test_committed_file_meets_the_contract(name):
    data = _read(name)
    assert contract(data) == ("rejected" if name in REFUSED else "array")
    if name not in REFUSED:
        got = imgio.load_image(data)
        want = ARRAYS[name]
        if name == mh.HT_1024:
            assert mh.digest(got).tobytes() == want.tobytes()
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_committed_set_is_whole():
    """Every file make_ht_files.py writes is committed and checked above,
    and the refused ones are the ones OpenJPEG is known to refuse."""
    assert sorted(mh.files()) == COMMITTED
    assert set(mh.HT_REFUSED) <= REFUSED
    assert all(n.startswith("p2_") for n in REFUSED - set(mh.HT_REFUSED))
    assert set(mh.HT_8BIT) | {mh.HT_GREY16} <= set(COMMITTED) - REFUSED


# ---------------------------------------------------------------------------
# 2. the encoder against OpenJPEG
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoded():
    return mh.ht_files()


def test_encoder_round_trips_through_pillow(encoded):
    mh.round_trip(encoded)
    lossless = [n for n, f in encoded.items() if f.lossless]
    assert "ht_cleanup_53_grey.j2c" in lossless and "ht_rgba.jp2" in lossless


def test_make_ht_files_rewrites_the_committed_bytes(encoded):
    for name, f in encoded.items():
        assert _read(name) == f.data, name
    for name, data in mh.part2_files().items():
        assert _read(name) == data, name


@pytest.mark.parametrize("name", [n for n in COMMITTED if n.startswith("ht_")])
def test_fixture_array_is_the_jax_decode(name):
    """ht_fixtures.npz holds the JAX package's decode of each file."""
    data = _read(name)
    if name in REFUSED:
        with pytest.raises(ValueError):
            jimgio.load_image(data)
        return
    want = jimgio.load_image(data).data
    if name == mh.HT_1024:
        assert mh.digest(want).tobytes() == ARRAYS[name].tobytes()
    else:
        assert np.array_equal(want, ARRAYS[name])


# ---------------------------------------------------------------------------
# 3. random cleanup segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", range(20))
def test_random_cleanup_segments_meet_the_contract(group):
    """Seeds 0-1999, 100 a case (make_ht_files.random_block)."""
    seen = set()
    for seed in range(group * 100, (group + 1) * 100):
        seen.add(contract(mh.random_block(np.random.default_rng(seed))))
    assert seen == {"array", "rejected"}


# ---------------------------------------------------------------------------
# 4. damage past the SOD
# ---------------------------------------------------------------------------

DAMAGED = [n for n in COMMITTED if n.startswith("ht_") and n not in REFUSED
           and n != mh.HT_1024] + ["p2_ht_mco_offset.j2c"]


@pytest.mark.parametrize("name", DAMAGED)
def test_damage_meets_the_contract(name):
    """Seeds 0-29: two bytes changed at positions drawn from past the
    first SOD."""
    data = _read(name)
    lo = data.find(b"\xff\x93") + 2
    for seed in range(30):
        rng = np.random.default_rng(seed)
        b = bytearray(data)
        for _ in range(2):
            b[int(rng.integers(lo, len(b)))] = int(rng.integers(0, 256))
        contract(bytes(b))


# ---------------------------------------------------------------------------
# 5. MQ blocks under the HT style bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("irreversible", (False, True))
@pytest.mark.parametrize("cblk", ((64, 64), (32, 32), (16, 64), (4, 4)))
def test_mq_blocks_with_the_ht_bit(cblk, irreversible):
    """Pillow-saved MQ codestreams, COD's code-block style given the HT bit:
    OpenJPEG decodes their bytes as HT blocks; seeds 0-4."""
    for seed in range(5):
        buf = io.BytesIO()
        Image.fromarray(mf.texture(24 + seed, 30, 3, 300 + seed)).save(
            buf, "JPEG2000", no_jp2=True, codeblock_size=cblk, irreversible=irreversible,
            num_resolutions=3)
        data = bytearray(buf.getvalue())
        data[data.find(b"\xff\x52") + 12] |= 0x40
        contract(bytes(data))


# ---------------------------------------------------------------------------
# 6. the JP2 brand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("brand", (b"jp2 ", b"jph ", b"jpx ", b"abcd"))
def test_brand_is_not_checked(brand):
    """OpenJPEG reads a JP2-family file whatever its ftyp brand, and Pillow
    opens it as JP2: a JPH file decodes as its JP2 twin."""
    data = bytearray(_read("ht_rgb.jph"))
    at = data.find(b"ftyp") + 4
    data[at:at + 4] = brand
    data[at + 8:at + 12] = brand
    assert contract(bytes(data)) == "array"
    assert np.array_equal(imgio.load_image(bytes(data)), ARRAYS["ht_rgb.jph"])
