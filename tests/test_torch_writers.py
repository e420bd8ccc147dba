"""The port's image writers against the JAX package's (Pillow 12.1):
gatling_tpu_torch.imgio.write_image_file against gatling_tpu.imgio.
write_image_file on the same arrays and base names for every extension of
Pillow's save registry and every mode the CLI hands it (L, RGB, RGBA);
gatling_tpu_torch.cli.write_output against gatling_tpu.cli._write_output
on the CLI's buffers (COLOR, NORMAL, DEPTH, OBJECT_ID, a grey float) with
gamma on and off; the native writer loops against their NumPy twins; and
tests/data/imgio/writers.json against Pillow's files.

The check of each extension (write_image_file's table): byte-equal files;
for JPEG 2000 (the port's own lossless bytes) Pillow opens the port's file
with the format, mode, size and samples it gives the JAX file; for PDF the
bytes are equal outside the two dates and, for RGBA, the JPX stream (whose
length moves the offsets after it), and that stream decodes, in Pillow and
in the port, to the array; where Pillow refuses, the same exception class.
"""

from __future__ import annotations

import base64
import hashlib
import importlib.util
import io
import json
import os
import re
import types

import numpy as np
import pytest
from PIL import Image

from gatling_tpu import cli as jcli
from gatling_tpu import imgio as jimgio
from gatling_tpu.interface import AovId as JAovId

from gatling_tpu_torch import cli as tcli
from gatling_tpu_torch import imgio
from gatling_tpu_torch.imgio import (eps, gif, ico, icns, jpeg2000, pcx, qoi, quantize,
                                     resample)
from gatling_tpu_torch.interface import AovId

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "imgio")
_spec = importlib.util.spec_from_file_location("make_fixtures",
                                               os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)

BYTE_EQUAL = (".png", ".apng", ".jpg", ".jpeg", ".jfif", ".jpe", ".mpo", ".tga", ".icb", ".vda",
              ".vst", ".tif", ".tiff", ".bmp", ".dib", ".pbm", ".pgm", ".ppm", ".pnm", ".pfm",
              ".dds", ".qoi", ".pcx", ".eps", ".ps", ".sgi", ".rgb", ".rgba", ".bw", ".im", ".gif",
              ".ico", ".icns")
J2K = (".j2k", ".j2c", ".jpc", ".jp2", ".jpf", ".jpx")
REFUSED = (".blp", ".msp", ".xbm", ".palm", ".bufr", ".grib", ".h5", ".hdf", ".emf", ".wmf")
READ_ONLY = (".cur", ".psd", ".xpm", ".fits", ".ras")
UNPORTED = (".webp", ".avif", ".avifs")
EXTS = BYTE_EQUAL + J2K + (".pdf",) + REFUSED + READ_ONLY + UNPORTED + (".xyz",)
MODES = {"L": 1, "RGB": 3, "RGBA": 4}
SIZES = ((1, 13), (11, 1), (17, 31))
ICON_SIZE = (300, 277)  # above 256 and not square: every ICO frame, aspect kept
# at least 512 x 512 GIF keeps the palette whole (a coarse RGBA image's 256
# octree entries, 9 in use), and the median cut over more than 65,536
# colours rescales its hash (writers.json's 1200 x 1200 arrays add the
# octree's transparent pick)
GIF_SIZE = (520, 512)


def test_registry_is_pillows():
    """Every extension Pillow 12.1 saves is in the port's table."""
    Image.init()
    # (a plugin loaded by another test may register more than the suffixes)
    known = {e: f for e, f in Image.EXTENSION.items() if e.startswith(".")}
    saved = {e for e, f in known.items() if f.upper() in Image.SAVE}
    assert {f for e, f in known.items() if e not in saved} == set(imgio.READ_ONLY_FORMATS)
    assert saved == {e for e, f in imgio.EXTENSION_FORMAT.items()
                     if f not in imgio.READ_ONLY_FORMATS}
    assert set(known) == set(imgio.EXTENSION_FORMAT)


def array(shape: tuple, channels: int, seed: int) -> np.ndarray:
    """Half the cases a texture, half noise (the GIF palette at 256)."""
    h, w = shape
    if seed % 2:
        return np.random.default_rng(seed).integers(0, 256, (h, w, channels), dtype=np.uint8)
    return mf.texture(h, w, channels, seed)


def write_both(tmp_path, name: str, img, port_write, jax_write):
    """Each writer into a directory of its own under the same file name:
    (port path or exception, JAX path or exception)."""
    out = []
    for sub, write in (("port", port_write), ("jax", jax_write)):
        path = tmp_path / sub / name
        path.parent.mkdir(exist_ok=True)
        try:
            write(str(path), img)
            out.append(path)
        except Exception as e:  # noqa: BLE001 - the class is what is compared
            assert not path.exists() or sub == "jax", f"the port left {path} behind"
            out.append(e)
    return out


def pdf_parts(data: bytes) -> tuple[bytes, bytes | None]:
    """A PDF with its dates, its JPX stream, that stream's /Length and the
    offsets it moves masked, and the JPX stream (None without one)."""
    data = re.sub(rb"\(D:\d{14}Z\)", b"(D:date)", data)
    jpx = None
    m = re.search(rb"/Filter /JPXDecode\n/SMaskInData 1\n/Length (\d+)\n>>stream\n", data)
    if m:
        n = int(m.group(1))
        jpx = data[m.end():m.end() + n]
        data = data[:m.start(1)] + b"N" + data[m.end(1):m.end()] + data[m.end() + n:]
        data = re.sub(rb"\d{10} 00000 n \n", b"offset n \n", data)
        data = re.sub(rb"startxref\n\d+\n", b"startxref\nN\n", data)
    return data, jpx


def check_files(port, ref, img, ext: str) -> None:
    """The check of ext's row in the table, on two written files (or the
    exceptions their writers raised)."""
    if isinstance(ref, Exception) or isinstance(port, Exception):
        if ext.lower() in UNPORTED:
            assert isinstance(port, NotImplementedError) and "ROADMAP" in str(port), port
            return
        assert type(port) is type(ref), (port, ref)
        return
    got, want = port.read_bytes(), ref.read_bytes()
    if ext.lower() in J2K:
        with Image.open(io.BytesIO(got)) as a, Image.open(io.BytesIO(want)) as b:
            assert (a.format, a.mode, a.size) == (b.format, b.mode, b.size)
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.array_equal(imgio.load_image(got), jimgio.load_image(want).data)
    elif ext.lower() == ".pdf":
        (g, gjpx), (w, wjpx) = pdf_parts(got), pdf_parts(want)
        assert g == w
        if gjpx is not None:
            with Image.open(io.BytesIO(gjpx)) as a:
                assert a.mode == "RGBA" and np.array_equal(np.asarray(a), img)
            assert np.array_equal(imgio.load_image(gjpx), img)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# 1. write_image_file against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ext", EXTS)
def test_write_image_file_as_jax(tmp_path, ext, mode):
    c = MODES[mode]
    sizes = SIZES + ((ICON_SIZE,) if ext in (".ico", ".icns") else ()) + (
        (GIF_SIZE,) if ext == ".gif" else ())
    images = [array(size, c, 10 * k + c) for k, size in enumerate(sizes)]
    if ext == ".gif":
        images.append(array(GIF_SIZE, c, 1) // 128 * 127)
    for k, img in enumerate(images):
        name = f"img_{k}{ext}"
        port, ref = write_both(tmp_path, name, img, imgio.write_image_file,
                               jimgio.write_image_file)
        check_files(port, ref, img, ext)
    floats = np.random.default_rng(c).uniform(-0.1, 1.1, (5, 7, c)).astype(np.float32)
    port, ref = write_both(tmp_path, f"f{ext}", floats, imgio.write_image_file,
                           jimgio.write_image_file)
    expected = np.clip(floats * 255.0 + 0.5, 0, 255).astype(np.uint8)
    check_files(port, ref, expected[..., 0] if c == 1 else expected, ext)


def test_grey_squeeze_as_jax(tmp_path):
    """A grey image one row high is written one column wide, and a 1 x 1
    grey image raises, as the JAX writer's squeeze makes Pillow do."""
    img = array((1, 9), 1, 3)
    port, ref = write_both(tmp_path, "row.png", img, imgio.write_image_file,
                           jimgio.write_image_file)
    assert port.read_bytes() == ref.read_bytes()
    with Image.open(port) as im:
        assert im.size == (1, 9)
    port, ref = write_both(tmp_path, "dot.png", np.zeros((1, 1, 1), np.uint8),
                           imgio.write_image_file, jimgio.write_image_file)
    assert type(port) is type(ref) is IndexError


# ---------------------------------------------------------------------------
# 2. the CLI's write_output against the JAX CLI's _write_output
# ---------------------------------------------------------------------------

CLI_EXTS = EXTS + (".exr", ".hdr", ".PNG", ".Gif", ".JPG", ".TIF")
# the CLI's buffers: COLOR 4 channels, NORMAL and DEPTH max(channels, 3), the ids int32
BUFFERS = {"COLOR": 4, "NORMAL": 3, "DEPTH": 3, "OBJECT_ID": 1, "DEPTH_GREY": 1}


def buffer(kind: str, h: int = 9, w: int = 7) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "OBJECT_ID":
        return rng.integers(0, 5, (h, w, 1)).astype(np.int32)
    lo = -1.0 if kind == "NORMAL" else 0.0
    return rng.uniform(lo, 1.3, (h, w, BUFFERS[kind])).astype(np.float32)


@pytest.mark.parametrize("kind", list(BUFFERS))
@pytest.mark.parametrize("ext", CLI_EXTS)
def test_write_output_as_jax_cli(tmp_path, ext, kind):
    aov = kind.split("_GREY")[0]
    img = buffer(kind)
    for gamma in (True, False):
        args = lambda path: types.SimpleNamespace(output=path, gamma_correction=gamma)  # noqa: E731
        port, ref = write_both(
            tmp_path, f"{kind}_{int(gamma)}OUT{ext}", img,
            lambda p, a: tcli.write_output(a, p, gamma, AovId[aov]),
            lambda p, a: jcli._write_output(a, args(p), JAovId[aov]))
        if isinstance(ref, Exception) or isinstance(port, Exception):
            check_files(port, ref, None, ext)
            continue
        got, want = port.read_bytes(), ref.read_bytes()
        if ext.lower() in (".exr", ".hdr"):
            assert got == want or np.array_equal(imgio.load_image(got),
                                                 jimgio.load_image(want).data)
            continue
        arr = np.clip(img[::-1] * 255.0 + 0.5, 0, 255).astype(np.uint8)  # an RGBA PDF's JPX
        check_files(port, ref, arr, ext)


def test_write_output_fault_repaired(tmp_path):
    """The cases the old write_output got wrong: a COLOR frame to .bmp and
    .ppm is linear RGBA / RGB as the JAX CLI writes it, OUT.PNG is RGBA,
    and a grey buffer to .bmp stays grey."""
    color = buffer("COLOR")
    for name in ("a.bmp", "a.ppm", "OUT.PNG"):
        port, ref = write_both(tmp_path, name, color, lambda p, a: tcli.write_output(a, p),
                               lambda p, a: jcli._write_output(
                                   a, types.SimpleNamespace(output=p, gamma_correction=True),
                                   JAovId.COLOR))
        assert port.read_bytes() == ref.read_bytes()
    with Image.open(tmp_path / "port" / "OUT.PNG") as im:
        assert im.mode == "RGBA"
    grey = buffer("DEPTH_GREY")
    tcli.write_output(grey, str(tmp_path / "d.bmp"), True, AovId.DEPTH)
    with Image.open(tmp_path / "d.bmp") as im:
        assert im.mode == "L"


# ---------------------------------------------------------------------------
# 3. the native loops against their NumPy twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filt", [resample.BICUBIC, resample.LANCZOS])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resample_native_vs_twin(filt, channels):
    rng = np.random.default_rng(channels + 10 * filt)
    for k in range(6):
        h, w = rng.integers(1, 70, 2)
        ow, oh = rng.integers(1, 90, 2)
        img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        img = img[..., 0] if channels == 1 else img
        got = resample.resize(img, ow, oh, filt)
        assert np.array_equal(got, resample.resize_ref(img, ow, oh, filt)), (h, w, ow, oh)
        pf = Image.Resampling.LANCZOS if filt == resample.LANCZOS else Image.Resampling.BICUBIC
        assert np.array_equal(got, np.asarray(Image.fromarray(img).resize((int(ow), int(oh)), pf)))


@pytest.mark.parametrize("size", [(1, 1), (16, 16), (20, 300), (300, 20), (257, 300), (33, 17)])
def test_thumbnail_size_as_pillow(size):
    w, h = size
    for box in ico.SIZES:
        im = Image.new("L", (w, h))
        im.thumbnail(box, Image.Resampling.LANCZOS, reducing_gap=None)
        assert (resample.thumbnail_size(w, h, box) or (w, h)) == im.size


@pytest.mark.parametrize("seed", range(4))
def test_mediancut_native_vs_twin(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(1, 50, 2)
    step = 1 + seed * 20
    img = (rng.integers(0, 256 // step + 1, (h, w, 3)) * step).clip(0, 255).astype(np.uint8)
    pal, idx = quantize.adaptive(img)
    assert all(np.array_equal(a, b) for a, b in zip((pal, idx), quantize.mediancut_ref(img)))
    ref = Image.fromarray(img).convert("P", palette=Image.Palette.ADAPTIVE)
    assert np.array_equal(pal.ravel(), np.frombuffer(ref.im.getpalette("RGB"), np.uint8))
    assert np.array_equal(idx, np.asarray(ref))


@pytest.mark.parametrize("seed", range(4))
def test_octree_native_vs_twin(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(1, 60, 2)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[..., 3][rng.random((h, w)) < 0.2 * seed] = 0
    pal, idx = quantize.adaptive(img)
    assert all(np.array_equal(a, b) for a, b in zip((pal, idx), quantize.octree_ref(img)))
    ref = Image.fromarray(img).quantize(256)
    assert np.array_equal(pal.ravel(), np.frombuffer(ref.im.getpalette("RGBA", "RGBA"), np.uint8))
    assert np.array_equal(idx, np.asarray(ref))


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("shape", [(1, 1), (16, 40), (130, 90)])
def test_gif_lzw_native_vs_twin(shape, interlace):
    """130 x 90 random indices fill the code table: clear codes mid-stream."""
    idx = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    assert gif.lzw_encode(idx, interlace) == gif.lzw_encode_ref(idx, interlace)


@pytest.mark.parametrize("channels", [1, 3])
def test_pcx_rle_native_vs_twin(channels):
    rng = np.random.default_rng(channels)
    for h, w in ((1, 1), (3, 130), (7, 9)):
        img = (rng.integers(0, 4, (h, w, channels)) * 85).astype(np.uint8)
        img[:, ::5] = 200  # literal bytes above 0xC0
        img = img[..., 0] if channels == 1 else img
        data = pcx.encode_pcx(img)
        assert data[128:128 + len(pcx.rle_ref(img))] == pcx.rle_ref(img)


@pytest.mark.parametrize("channels", [3, 4])
def test_qoi_native_vs_twin(channels):
    rng = np.random.default_rng(channels)
    img = (rng.integers(0, 3, (19, 23, channels)) * rng.integers(1, 90)).astype(np.uint8)
    img[5:9] = 7  # runs
    assert qoi.encode_qoi(img)[14:] == qoi.ops_ref(img)


@pytest.mark.parametrize("orient", range(4))
def test_j2k_tier1_native_vs_twin(orient):
    rng = np.random.default_rng(orient)
    for h, w in ((1, 1), (4, 4), (9, 13), (16, 16)):
        coef = rng.integers(-200, 200, (h, w)) * (rng.random((h, w)) < 0.5)
        assert jpeg2000.encode_cblk(coef, orient) == jpeg2000.encode_cblk_ref(coef, orient)
    assert jpeg2000.encode_cblk(np.zeros((4, 4), np.int32), orient) == (b"", 0, 0)


@pytest.mark.parametrize("shape", [(1, 1), (2, 9), (17, 31), (64, 70)])
def test_fdwt53_native_vs_twin_and_inverse(shape):
    data = np.random.default_rng(shape[1]).integers(-128, 128, shape).astype(np.int32)
    levels = jpeg2000.levels_for(shape[1], shape[0])
    got = jpeg2000.fdwt53(data, levels)
    assert np.array_equal(got, jpeg2000.fdwt53_ref(data, levels))
    rects = jpeg2000.resolution_rects(0, 0, shape[1], shape[0], levels + 1)
    assert np.array_equal(jpeg2000.idwt(got, rects, True), data)


def test_eps_payload_reads_back():
    img = array((17, 31), 3, 2)
    assert np.array_equal(eps.hex_payload(eps.encode_eps(img)), img)
    assert np.array_equal(eps.hex_payload(eps.encode_eps(img[..., 0])), img[..., 0])


def test_icon_frames_read_back():
    """Each ICO and ICNS frame decodes (the port's PNG decoder) to the
    port's resample of the image."""
    img = array(ICON_SIZE, 4, 5)
    data = ico.encode_ico(img)
    frames = ico.frames(img)
    assert len(frames) == 7
    for k, f in enumerate(frames):
        size, offset = np.frombuffer(data[6 + 16 * k + 8:6 + 16 * k + 16], "<u4")
        assert np.array_equal(imgio.decode_png(data[offset:offset + size]), f)
    data = icns.encode_icns(img)
    for side, frame in icns.save_frames(img).items():
        assert icns.save_frames(img)[side].shape == (side, side, 4)
        assert imgio.encode_png(frame) in data


# ---------------------------------------------------------------------------
# 4. writers.json
# ---------------------------------------------------------------------------

def test_writers_json_is_pillows():
    """make_fixtures.py writes the committed writers.json (Pillow 12.1's
    hashes), and the port's file of each array has Pillow's hash."""
    with open(os.path.join(FIXTURES, "writers.json")) as f:
        doc = json.load(f)
    assert doc == json.loads(json.dumps(mf.writers()))
    for mode, a in doc["arrays"].items():
        arr = np.frombuffer(base64.b64decode(a["base64"]), np.uint8).reshape(a["shape"])
        for ext, digest in doc["sha256"][mode].items():
            got = imgio.encode_image(doc["name"] + ext, arr)
            assert hashlib.sha256(got).hexdigest() == digest, (mode, ext)
    full = doc["full_size"]
    for mode, digests in full["sha256"].items():
        arr = mf.writer_ramp(mode, *full["shape"])
        for ext, digest in digests.items():
            got = imgio.encode_image(doc["name"] + ext, arr)
            assert hashlib.sha256(got).hexdigest() == digest, (mode, ext)
            if ext == ".jpg":
                samples = imgio.load_image(got).tobytes()
                assert hashlib.sha256(samples).hexdigest() == full["jpeg_decoded"][mode], mode
