"""MaterialX in the port against the JAX package, and the slice's
content end to end.

1. render/mtlx.py: `parse_mtlx` on the documents of
   tests/test_material_frontends.py and tests/test_shadergraph.py
   (standard_surface, a nodegraph texture, Windows asset paths, a custom
   nodedef's inline expansion, open_pbr's bundled nodedef defaults, frame
   and time nodes) builds the JAX package's network node for node, and
   `lower_material` lowers it to the same parameters, textures and traits
   (tolerance 0); `load_mtlx` likewise, and `gi.giCreateMaterialFromMtlxStr`
   / `giCreateMaterialFromMtlxDoc` add it to a scene.
2. Frame and time nodes at frames 0, 10 and 60 (Materials.MtlxFrame's
   emission): JAX's values; gi lowers only the animated material anew when
   the frame setting changes: the pool and fused tables stay while the
   texture requests do, the frame equals a fresh scene's at that frame bit
   for bit, and a frame-driven texture scale rebuilds them.
3. The slice as a whole: a small skinned, procedurally shaded .usdz (a
   crate layer, UsdSkel figures, a checkerboard, a noise roughness, a
   two-texture composite, a frame-driven emission) renders through the
   port's CLI on the CPU; its PNG is that render, and the render agrees in
   distribution with gatling_tpu.cli.render_scene_file (the JAX wavefront
   on the CPU) with tests/test_torch_render.py's bounds: means within 12 %,
   4x4-block correlation above 0.95.
"""

import io

import numpy as np
import pytest
from PIL import Image

from gatling_tpu.cli import render_scene_file as jrender_scene_file
from gatling_tpu.render import material as jmat
from gatling_tpu.render.mtlx import load_mtlx as jload_mtlx
from gatling_tpu.render.mtlx import parse_mtlx as jparse_mtlx
from gatling_tpu.utils.config import default_settings as jdefaults

from gatling_tpu_torch import cli, gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.render import material as tmat
from gatling_tpu_torch.render.mtlx import load_mtlx, parse_mtlx
from gatling_tpu_torch.scene import examples
from gatling_tpu_torch.scene.meshproc import Interpolation, build_triangulated_mesh
from gatling_tpu_torch.scene.stage import CameraDesc, LightDesc, MeshDesc

from test_material_frontends import MTLX_STANDARD_SURFACE, MTLX_TEXTURED
from test_torch_bvh import one_thread  # noqa: F401 (an autouse fixture)
from test_torch_render import _srgb8

FRAME_DOC = """<?xml version="1.0"?>
<materialx version="1.38">
  <frame name="fr" type="float" />
  <time name="tm" type="float">
    <input name="fps" type="float" value="10" />
  </time>
  <multiply name="glow" type="color3">
    <input name="in1" type="float" nodename="fr" />
    <input name="in2" type="color3" value="0.005, 0.01, 0.002" />
  </multiply>
  <standard_surface name="SR" type="surfaceshader">
    <input name="emission" type="float" value="1.0" />
    <input name="emission_color" type="color3" nodename="glow" />
    <input name="metalness" type="float" nodename="tm" />
  </standard_surface>
</materialx>"""
NODEDEF_DOC = """<?xml version="1.0"?>
<materialx version="1.38">
  <nodedef name="ND_double_color3" node="double">
    <input name="in" type="color3" value="0.0, 0.0, 0.0" />
    <output name="out" type="color3" />
  </nodedef>
  <nodegraph name="NG_double_color3" nodedef="ND_double_color3">
    <multiply name="m1" type="color3">
      <input name="in1" type="color3" interfacename="in" />
      <input name="in2" type="color3" value="2.0, 2.0, 2.0" />
    </multiply>
    <output name="out" type="color3" nodename="m1" />
  </nodegraph>
  <double name="d1" type="color3">
    <input name="in" type="color3" value="0.1, 0.2, 0.3" />
  </double>
  <standard_surface name="SR" type="surfaceshader">
    <input name="base_color" type="color3" nodename="d1" />
  </standard_surface>
</materialx>"""
OPEN_PBR_DOC = """<?xml version="1.0"?>
<materialx version="1.38">
  <open_pbr_surface name="SR" type="surfaceshader">
    <input name="base_color" type="color3" value="0.5, 0.5, 0.5" />
  </open_pbr_surface>
</materialx>"""
WINDOWS_PATH_DOC = """<?xml version="1.0"?>
<materialx version="1.38">
  <standard_surface name="s" type="surfaceshader">
    <input name="base_color" type="color3" nodename="tex" />
  </standard_surface>
  <image name="tex" type="color3">
    <input name="file" type="filename" value="C:\\assets\\wood.png" />
  </image>
</materialx>"""
DOCS = {"standard_surface": MTLX_STANDARD_SURFACE, "nodegraph_texture": MTLX_TEXTURED,
        "frame_time": FRAME_DOC, "custom_nodedef": NODEDEF_DOC, "open_pbr": OPEN_PBR_DOC,
        "windows_path": WINDOWS_PATH_DOC}


def _network(desc):
    return (desc.path, desc.surface_node, desc.base_dir, sorted(
        (n.path, n.shader_id, sorted(n.inputs.items()), sorted(n.input_connections.items()))
        for n in desc.nodes.values()))


def _same_lowering(trow, jrow):
    assert trow.params == jrow.params
    assert trow.traits.is_animated == jrow.traits.is_animated
    assert trow.traits.has_cutout == jrow.traits.has_cutout
    assert set(trow.textures) == set(jrow.textures)
    for k, ref in trow.textures.items():
        jref = jrow.textures[k]
        assert (ref.file_path, ref.is_srgb, ref.wrap_s, ref.wrap_t, ref.scale, ref.bias,
                ref.channel) == (jref.file_path, jref.is_srgb, jref.wrap_s, jref.wrap_t,
                                 jref.scale, jref.bias, jref.channel)


@pytest.mark.parametrize("frame", [0.0, 10.0, 60.0])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_parse_and_lower_match_jax(name, frame):
    desc, jdesc = parse_mtlx(DOCS[name], name=name), jparse_mtlx(DOCS[name], name=name)
    assert _network(desc) == _network(jdesc)
    trow, jrow = tmat.lower_material(desc, frame), jmat.lower_material(jdesc, frame=frame)
    _same_lowering(trow, jrow)
    if name == "frame_time":
        assert trow.traits.is_animated
        np.testing.assert_allclose(trow.params["emissive"], np.multiply(frame, (0.005, 0.01,
                                                                                0.002)))
        assert trow.params["metallic"] == frame / 10.0
    if name == "custom_nodedef":
        np.testing.assert_allclose(trow.params["base_color"], (0.2, 0.4, 0.6), atol=1e-6)
    if name == "open_pbr":  # the bundled nodedef's defaults
        assert abs(trow.params["roughness"] - 0.3) < 1e-6 and abs(trow.params["ior"] - 1.6) < 1e-6
    if name == "windows_path":
        (tex,) = [n for n in desc.nodes.values() if n.shader_id == "image"]
        assert tex.inputs["file"].endswith("assets/wood.png") and "\\" not in tex.inputs["file"]


def test_load_mtlx_and_gi_api(tmp_path):
    path = tmp_path / "tex.mtlx"
    path.write_text(MTLX_TEXTURED)
    desc, jdesc = load_mtlx(path), jload_mtlx(path)
    assert _network(desc) == _network(jdesc) and desc.base_dir == str(tmp_path)
    _same_lowering(tmat.lower_material(desc), jmat.lower_material(jdesc))
    scene = gi.create_scene("cpu")
    mat = gi.giCreateMaterialFromMtlxStr(scene, "brass", MTLX_STANDARD_SURFACE)
    assert scene.materials[mat.path] is mat and mat.path == "/brass"
    doc = gi.giCreateMaterialFromMtlxDoc(scene, "tex", str(path))
    assert scene.materials[doc.path] is doc and doc.path == "/tex"
    assert scene.dirty & gi.DirtyFlags.MATERIALS


def _quad_scene(material_path, desc):
    scene = gi.create_scene("cpu")
    pts = np.array([[-1, -1, 0], [1, -1, 0], [-1, 1, 0], [1, 1, 0]], np.float32)
    mesh = build_triangulated_mesh(pts, np.array([4]), np.array([0, 1, 3, 2]),
                                   uvs=np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32),
                                   uvs_interp=Interpolation.VERTEX)
    scene.add_mesh(MeshDesc(path="/quad", mesh=mesh, transform=np.eye(4),
                            material=material_path, double_sided=True, object_id=0))
    scene.add_material(desc)
    xf = np.eye(4)
    xf[3, :3] = [0.0, 0.0, 2.0]
    scene.add_light(LightDesc(
        path="/key", light_type="rect", transform=xf,
        params=dict(intensity=4.0, exposure=0.0, color=np.ones(3, np.float32), normalize=False,
                    diffuse=1.0, specular=1.0, enableColorTemperature=False,
                    colorTemperature=6500.0, width=1.0, height=1.0)))
    return scene


def _frame(scene, frame):
    cam = CameraDesc(position=np.array([0, 0, 3], np.float32),
                     forward=np.array([0, 0, -1], np.float32),
                     up=np.array([0, 1, 0], np.float32), vfov=0.8)
    buf = gi.GiRenderBuffer(8, 8, 4)
    gi.render(gi.GiRenderParams(scene=scene, camera=cam,
                                aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                                render_settings=dict(jdefaults(), spp=2, maxBounces=2,
                                                     nextEventEstimation=True, frame=frame)))
    return buf.data.copy()


TEX_FRAME_DOC = """<?xml version="1.0"?>
<materialx version="1.38">
  <frame name="fr" type="float" />
  <image name="img" type="color3">
    <input name="file" type="filename" value="{file}" />
  </image>
  <multiply name="scaled" type="color3">
    <input name="in1" type="color3" nodename="img" />
    <input name="in2" type="float" nodename="fr" />
  </multiply>
  <standard_surface name="SR" type="surfaceshader">
    <input name="base_color" type="color3" nodename="scaled" />
  </standard_surface>
</materialx>"""


@pytest.mark.parametrize("textured", [False, True])
def test_frame_change_relowers_animated_material(tmp_path, monkeypatch, textured):
    """A frame change under an animated material: gi.render lowers it (and
    it alone) anew; with the same texture requests the pool and the fused
    triangle tables stay and the material rows are swapped in place, with a
    frame-driven texture scale they are rebuilt; either way the frame
    equals a fresh scene's at the new frame, bit for bit."""
    if textured:
        from gatling_tpu_torch import imgio

        rgba = np.random.default_rng(2).integers(0, 256, (8, 8, 4)).astype(np.uint8)
        imgio.write_image_file(tmp_path / "t.png", rgba)
        doc = TEX_FRAME_DOC.format(file=str(tmp_path / "t.png"))
    else:
        doc = FRAME_DOC
    calls = []
    real = gi.lower_material
    monkeypatch.setattr(gi, "lower_material", lambda *a, **k: calls.append(a) or real(*a, **k))
    scene = _quad_scene("/m", parse_mtlx(doc, name="m"))
    _frame(scene, 2.0)
    assert len(calls) == 2  # the material and the fallback row
    pool, tris = scene._texture_pool, scene._fused.tris
    got = _frame(scene, 5.0)
    assert len(calls) == 3 and scene._lowered_frame == 5.0
    assert (scene._texture_pool is pool) == (not textured)
    assert (scene._fused.tris is tris) == (not textured)
    fresh = _quad_scene("/m", parse_mtlx(doc, name="m"))
    np.testing.assert_array_equal(got, _frame(fresh, 5.0))
    np.testing.assert_array_equal(scene._material_table.packed_f, fresh._material_table.packed_f)
    assert not np.array_equal(got, _frame(_quad_scene("/m", parse_mtlx(doc, name="m")), 2.0))


@pytest.fixture(scope="module")
def small_usdz(tmp_path_factory):
    """chip_smoke.py's content scene at 6 figures of 8 x 12 quads (1,154
    triangles; figure 5 the frame-driven emission), 64x64 textures, as
    a .usdz of its crate layer."""
    d = tmp_path_factory.mktemp("content")
    usda = examples.write_content(str(d), figures=6, rings=8, segments=12, joints=6, tex_res=64)
    usdz = str(d / "content.usdz")
    examples.pack_usdz(usda, usdz)
    return usdz


def test_content_usdz_cli_matches_jax_in_distribution(small_usdz, tmp_path):
    w = h = 24
    settings = dict(jdefaults(), spp=32, maxBounces=4, frame=12.0, nextEventEstimation=True)
    out = tmp_path / "content.png"
    assert cli.main([small_usdz, str(out), "--device", "cpu", "--image-width", str(w),
                     "--image-height", str(h), "--spp", "32", "--max-bounces", "4",
                     "--frame", "12"]) == 0
    png = np.asarray(Image.open(io.BytesIO(out.read_bytes())))
    port, scene = cli.render_scene_file(small_usdz, w, h, settings, device="cpu")
    st = scene._fused_static
    assert st.textured and scene._texture_pool.count == 4 and scene._texture_pool.packed
    assert any(m.traits.is_animated for m in scene._lowered_materials)
    assert png.shape == (h, w, 3)
    # the CLI's settings: its flags' defaults over the file's (NEE off)
    settings_cli = dict(jdefaults(), spp=32, maxBounces=4, frame=12.0)
    cli_img, _ = cli.render_scene_file(small_usdz, w, h, settings_cli, device="cpu")
    np.testing.assert_array_equal(png, _srgb8(cli_img))  # the PNG is the CLI's render

    ref, _ = jrender_scene_file(small_usdz, w, h, settings)
    f, g = port[..., :3], ref[..., :3]
    assert np.isfinite(f).all() and (f >= 0).all() and g.mean() > 0.01
    assert abs(f.mean() - g.mean()) / g.mean() < 0.12
    fd = f.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3)).ravel()
    gd = g.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3)).ravel()
    assert np.corrcoef(fd, gd)[0, 1] > 0.95
