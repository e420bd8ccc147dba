"""The port runs where neither JAX nor Pillow nor ml_dtypes nor the JAX
package is installed (the GPU machine has torch, numpy and the CUDA
toolkit only): in a fresh interpreter that cannot import them, every
module of gatling_tpu_torch imports, and 8x8 frames of the Cornell box, of
an instanced scene and of the textured interior (its PNG textures written
and decoded by the port) render on the CPU, the interior also through
the wavefront integrator, a Cornell box with an MDL fog volume (the
port's own MDL front end) in the fused scatter mode, USD content (a
.usdz of a crate layer the port wrote, with UsdSkel figures and MaterialX
graphs it bakes, and a MaterialX document through its own nodedefs), and
the interior textured with a JPEG and a TIFF fixture (tests/data/imgio),
which the port decodes without Pillow, and fixtures of the remaining
formats (BMP, GIF, DDS BC7, PSD, QOI, PPM, 16-bit TGA, JPEG-in-TIFF, CMYK
JPEG, PFM) equal to Pillow's arrays; and the front ends: the Hydra
delegate with a gi rect light, giDestroyMesh, a checkpoint saved and
loaded, the driver entry's multi-device dry run, and the CLI with
parallelDevices and --checkpoint, and the CLI's frames written to .gif and
.jp2 and read back by the port's decoders. A scan of the port's sources finds no
import of jax, PIL or the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "PIL", "ml_dtypes", "gatling_tpu")
for name in BLOCKED:
    sys.modules[name] = None  # any import of these raises ImportError
import gatling_tpu_torch
for mod in pkgutil.walk_packages(gatling_tpu_torch.__path__, "gatling_tpu_torch."):
    importlib.import_module(mod.name)
from gatling_tpu_torch.cli import render_scene_file
img, scene = render_scene_file("tests/data/cornell.usda", 8, 8, {"spp": 1, "maxBounces": 3},
                               device="cpu")
assert img.shape == (8, 8, 4) and scene.sample_offset == 1
assert img[..., :3].max() > 0.0
from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.scene.examples import sphere_field
desc = sphere_field(n_side=6, sphere_res=8)
scene = gi.create_scene("cpu")
for m in desc.meshes:
    scene.add_mesh(m)
for m in desc.materials.values():
    scene.add_material(m)
buf = gi.GiRenderBuffer(8, 8, 4)
gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                            aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                            render_settings={"spp": 1, "maxBounces": 2}))
assert scene._fused_static.instanced and buf.data[..., :3].max() > 0.0
import tempfile
from gatling_tpu_torch.scene.examples import interior
desc = interior(detail=1, tex_dir=tempfile.mkdtemp())  # PNGs written and read without Pillow
scene = gi.create_scene("cpu")
for m in desc.meshes:
    scene.add_mesh(m)
for m in desc.materials.values():
    scene.add_material(m)
for light in desc.lights:
    scene.add_light(light)
buf = gi.GiRenderBuffer(8, 8, 4)
gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                            aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                            render_settings={"spp": 1, "maxBounces": 2,
                                             "nextEventEstimation": True}))
assert scene._fused_static.textured and scene._texture_pool.count == 6
assert buf.data[..., :3].max() > 0.0
ids = gi.GiRenderBuffer(8, 8, 1, is_int=True)  # an id AOV: the wavefront integrator
gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                            aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf),
                                          gi.GiAovBinding(AovId.OBJECT_ID, ids, clear_value=-1)],
                            render_settings={"spp": 1, "maxBounces": 2,
                                             "nextEventEstimation": True}))
assert scene._accel is not None and (ids.data >= 0).any()
from gatling_tpu_torch.scene.examples import cornell_fog  # an MDL medium: the scatter mode
img, scene = render_scene_file(cornell_fog(tempfile.mkdtemp()), 8, 8,
                               {"spp": 1, "maxBounces": 3, "mediumStackSize": 1}, device="cpu")
assert scene._fused.volumes == 2 and img[..., :3].max() > 0.0
from gatling_tpu_torch.scene.examples import pack_usdz, write_content  # USD content
d = tempfile.mkdtemp()
pack_usdz(write_content(d, figures=6, rings=8, segments=12, joints=6, tex_res=32),
          d + "/content.usdz")
img, scene = render_scene_file(d + "/content.usdz", 8, 8,
                               {"spp": 1, "maxBounces": 2, "frame": 12.0}, device="cpu")
assert scene._texture_pool.count == 4 and img[..., :3].max() > 0.0
assert any(m.traits.is_animated for m in scene._lowered_materials)
desc = interior(detail=1, tex_dir=tempfile.mkdtemp())  # a JPEG and a TIFF base colour
for k, path in enumerate(sorted(desc.materials)):
    desc.materials[path].nodes[path + "/tex"].inputs["file"] = (
        "tests/data/imgio/jpeg_420.jpg", "tests/data/imgio/tiff_lzw_pred2.tif")[k % 2]
scene = gi.create_scene("cpu")
for m in desc.meshes:
    scene.add_mesh(m)
for m in desc.materials.values():
    scene.add_material(m)
for light in desc.lights:
    scene.add_light(light)
gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                            aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                            render_settings={"spp": 1, "maxBounces": 2,
                                             "nextEventEstimation": True}))
assert scene._texture_pool.count == 2 and scene._texture_pool.packed
assert buf.data[..., :3].max() > 0.0
from gatling_tpu_torch.render.mtlx import parse_mtlx
assert parse_mtlx('<materialx><open_pbr_surface name="s" type="surfaceshader"/></materialx>',
                  name="m").nodes["/m/s"].inputs["specular_roughness"] == 0.3
from gatling_tpu_torch.hydra import HdAovBinding, get_renderer_plugin  # the front ends
from gatling_tpu_torch.scene.stage import load_scene
delegate = get_renderer_plugin().create_render_delegate("cpu")
desc = load_scene("tests/data/cornell.usda")
meshes = [delegate.sync_mesh(m) for m in desc.meshes]
for m in desc.materials.values():
    delegate.sync_material(m)
light = gi.giCreateRectLight(delegate.scene)
gi.giSetRectLightOrigin(light, (0.0, 0.0, 0.9))
gi.giSetRectLightBaseEmission(light, (4.0, 3.6, 3.2))
delegate.set_render_setting("spp", 2)
delegate.set_render_setting("nextEventEstimation", True)
hd = delegate.create_render_buffer(8, 8)
delegate.create_render_pass().execute(desc.first_camera(), [HdAovBinding("color", hd)])
gi.giDestroyMesh(delegate.scene, meshes[2])
ckpt = tempfile.mkdtemp() + "/c.npz"
gi.giSaveCheckpoint(delegate.scene, ckpt)
assert gi.giLoadCheckpoint(gi.create_scene("cpu"), ckpt) == 2 and hd.map()[..., :3].max() > 0
from gatling_tpu_torch import entry
entry.dryrun_multidevice(2, "cpu")  # render_frame_sharded, render_fused_sharded
img, scene = render_scene_file("tests/data/cornell.usda", 8, 8,
                               {"spp": 2, "maxBounces": 2, "parallelDevices": 2}, device="cpu",
                               checkpoint=tempfile.mkdtemp() + "/cli.npz")
assert scene.sample_offset == 2 and img[..., :3].max() > 0.0
import numpy as np
from gatling_tpu_torch import imgio  # the remaining formats, decoded without Pillow
ref = np.load("tests/data/imgio/fixtures.npz")
for name in ("bmp_rgb24.bmp", "gif_palette.gif", "dds_bc7.dds", "psd_rgb.psd", "qoi_rgba.qoi",
             "ppm_rgb.ppm", "tga_rgb16.tga", "tiff_jpeg.tif", "jpeg_cmyk.jpg", "pfm_grey.pfm"):
    with open("tests/data/imgio/" + name, "rb") as f:
        got = imgio.load_image(f.read())
    assert got.dtype == ref[name].dtype and np.array_equal(got, ref[name]), name
from gatling_tpu_torch import cli  # the CLI's writers: .gif and .jp2, read back by the port
from gatling_tpu_torch.imgio import gif
written = {}
write = imgio.write_image_file
imgio.write_image_file = lambda path, a: (written.__setitem__(path, a), write(path, a))[1]
out_dir = tempfile.mkdtemp()
for ext in (".gif", ".jp2"):
    assert cli.main(["tests/data/cornell.usda", out_dir + "/frame" + ext, "--device", "cpu",
                     "--image-width", "8", "--image-height", "8", "--spp", "1",
                     "--max-bounces", "2"]) == 0
imgio.write_image_file = write
for ext in (".gif", ".jp2"):
    path = out_dir + "/frame" + ext
    u8 = np.clip(written[path] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    got = imgio.load_image_file(path)
    if ext == ".jp2":
        assert np.array_equal(got, u8), ext  # lossless RGBA
    else:
        pal, idx, clear = gif.indexed(u8)  # the quantizer's palette at its indices
        assert np.array_equal(got[..., :3], pal[idx])
        assert np.array_equal(got[..., 3], np.where(idx == clear, 0, 255))
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None]
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_no_port_module_imports_pil_or_jax():
    """No module of the port imports jax, PIL or the JAX package, at module
    level or inside a function (the card's host has none of them)."""
    import ast

    root = os.path.join(REPO, "gatling_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for name in names:
                    assert name.split(".")[0] not in ("jax", "jaxlib", "PIL", "gatling_tpu"), \
                        (path, name)


def test_port_imports_and_renders_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout
