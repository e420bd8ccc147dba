"""Asset readers and the texture formats through the port's texture path,
against the JAX package's.

1. The reader registry (render/assets.py, a copy of the JAX package's):
   the mmap reader, an in-memory reader registered after it, a missing
   asset and an empty file read the same bytes (or None) in both packages;
   gi exports the registration under both names, as the JAX gi does.
2. `build_pool` of materials textured in JPEG, TGA, TIFF and 16-bit grey
   PNG (which makes the pool float) equals the JAX pool bit for bit, and
   so does the 8-bit pool of the JPEG, TGA and TIFF slots alone; a texture
   served by a registered reader gives the pool of its file.
3. A small USD content scene whose textures are JPEG, TGA and TIFF files
   renders through gatling_tpu_torch.cli and gatling_tpu.cli (the JAX
   wavefront on the CPU), and the two agree in distribution with
   tests/test_torch_render.py's bounds: means within 12 %, 4x4-block
   correlation above 0.95.
"""

import os

import numpy as np
import pytest

from gatling_tpu import gi as jgi
from gatling_tpu import imgio as jimgio
from gatling_tpu.cli import render_scene_file as jrender_scene_file
from gatling_tpu.render import assets as jassets
from gatling_tpu.render import texture as jtex
from gatling_tpu.utils.config import default_settings as jdefaults

from gatling_tpu_torch import cli, gi, imgio
from gatling_tpu_torch.render import assets as tassets
from gatling_tpu_torch.render import texture as ttex
from gatling_tpu_torch.scene import examples

from test_torch_bvh import one_thread  # noqa: F401 (an autouse fixture)
from test_torch_imgio import mf

LIBS = ((jassets, jtex), (tassets, ttex))


@pytest.fixture
def fresh_registry(monkeypatch):
    """Each package's process-wide aggregate replaced by a new one seeded
    with the mmap reader, as at giInitialize."""
    for assets, _tex in LIBS:
        agg = assets.GiAggregateAssetReader()
        agg.register(assets.GiMmapAssetReader())
        monkeypatch.setattr(assets, "_aggregate", agg)


def _memory_reader(assets, blobs: dict):
    class Memory(assets.GiAssetReader):
        def open(self, path):
            data = blobs.get(path)
            return None if data is None else assets.GiAsset(data, len(data))

    return Memory()


def test_reader_registry_matches_jax(fresh_registry, tmp_path):
    path = tmp_path / "a.bin"
    path.write_bytes(b"\x00\x01 bytes")
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    blobs = {"mem://texture": b"served from memory", str(path): b"shadowed"}
    got = []
    for assets, _tex in LIBS:
        before = assets.read_asset("mem://texture")
        assets.gi_register_asset_reader(_memory_reader(assets, blobs))
        got.append((before, assets.read_asset("mem://texture"), assets.read_asset(str(path)),
                    assets.read_asset(str(tmp_path / "missing")), assets.read_asset(str(empty))))
    assert got[0] == got[1] == (None, b"served from memory", b"\x00\x01 bytes", None, b"")
    assert gi.giRegisterAssetReader is tassets.gi_register_asset_reader
    assert gi.gi_register_asset_reader is tassets.gi_register_asset_reader
    assert jgi.giRegisterAssetReader is jassets.gi_register_asset_reader


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JPEG (4:2:0), a TGA (run-length), a TIFF (LZW, predictor 2) and a
    16-bit grey PNG, written by Pillow (make_fixtures.py)."""
    d = tmp_path_factory.mktemp("formats")
    out = {}
    for key, name, data in (
            ("jpg", "a.jpg", mf.pillow(mf.texture(37, 29, 3, 1), "JPEG")),
            ("tga", "b.tga", mf.pillow(mf.texture(12, 17, 4, 2), "TGA", compression="tga_rle")),
            ("tif", "c.tif", mf.pillow(mf.texture(21, 9, 3, 3), "TIFF", compression="tiff_lzw",
                                       tiffinfo={317: 2})),
            ("png16", "d.png", mf.raw_png(mf.texture(11, 13, 1, 4, depth=16)))):
        out[key] = str(d / name)
        with open(out[key], "wb") as f:
            f.write(data)
    return out


def _refs(tex, files, keys):
    wraps = ("repeat", "clamp", "mirror", "black")
    return [tex.TextureRef(file_path=files[k], is_srgb=i % 2 == 0, wrap_s=wraps[i],
                           wrap_t=wraps[-1 - i]) for i, k in enumerate(keys)]


def _pools_equal(jp, tp):
    for name in ttex.TexturePool._fields:
        ref, got = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        if ref.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("keys", [("jpg", "tga", "tif", "png16"), ("jpg", "tga", "tif"),
                                  ("png16", "tif")])
def test_build_pool_matches_jax(files, keys):
    jp = jtex.TextureManager().build_pool(_refs(jtex, files, keys))
    tp = ttex.TextureManager().build_pool(_refs(ttex, files, keys))
    _pools_equal(jp, tp)
    assert tp.packed == ("png16" not in keys)  # a 16-bit grey PNG makes the pool float


def test_pool_through_a_registered_reader(fresh_registry, files):
    """Texture paths that exist nowhere on disk, served by a reader: the
    pools equal the pools of the files themselves, in both packages."""
    keys = ("jpg", "tga", "tif", "png16")
    virtual = {k: f"mem://{k}" for k in keys}
    blobs = {virtual[k]: open(files[k], "rb").read() for k in keys}
    pools = []
    for assets, tex in LIBS:
        assets.gi_register_asset_reader(_memory_reader(assets, blobs))
        pools.append(tex.TextureManager().build_pool(_refs(tex, virtual, keys)))
    _pools_equal(*pools)
    _pools_equal(jtex.TextureManager().build_pool(_refs(jtex, files, keys)), pools[1])


@pytest.fixture(scope="module")
def formats_usda(tmp_path_factory):
    """chip_smoke.py's content scene, small, with its ground a JPEG, its
    stripes a TGA and its gradient a TIFF, all written by the port."""
    d = tmp_path_factory.mktemp("content_formats")
    usda = examples.write_content(str(d), figures=6, rings=8, segments=12, joints=6, tex_res=64)
    return examples.retexture(usda, {"ground.png": ".jpg", "stripes.png": ".tga",
                                     "gradient.png": ".tif"}, "formats")


def test_formats_scene_cli_matches_jax_in_distribution(formats_usda, tmp_path):
    w = h = 24
    settings = dict(jdefaults(), spp=32, maxBounces=4, frame=12.0, nextEventEstimation=True)
    text = open(formats_usda).read()
    assert "@ground.jpg@" in text and "@stripes.tga@" in text and "@gradient.tif@" in text
    port, scene = cli.render_scene_file(formats_usda, w, h, settings, device="cpu")
    assert scene._texture_pool.count == 4 and scene._texture_pool.packed
    # the decoded ground is the JAX package's decode of the port's JPEG
    ground = os.path.join(os.path.dirname(formats_usda), "ground.jpg")
    np.testing.assert_array_equal(imgio.load_image_file(ground),
                                  jimgio.load_image_file(ground).data)
    ref, _ = jrender_scene_file(formats_usda, w, h, settings)
    f, g = port[..., :3], ref[..., :3]
    assert np.isfinite(f).all() and (f >= 0).all() and g.mean() > 0.01
    assert abs(f.mean() - g.mean()) / g.mean() < 0.12
    fd = f.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3)).ravel()
    gd = g.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3)).ravel()
    assert np.corrcoef(fd, gd)[0, 1] > 0.95
