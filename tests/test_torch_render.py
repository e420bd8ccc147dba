"""The port's render path against the JAX package's.

1. render_pixels_fused: the port (plain twin on the CPU) against the JAX
   fused path in Pallas interpret mode, Cornell 16x16, 2 spp, 3 bounces,
   NEE off and on, the same sample indices: per-pixel agreement. Outliers
   come from the rare ray whose path flips on a last-bit difference of a
   cos/sin/log between XLA and PyTorch.
2. The CLI on the CPU writes the PNG of its render; that render agrees in
   distribution with gatling_tpu.cli.render_scene_file, which on the CPU
   takes the wavefront integrator (mesh-tangent shading frame instead of
   the kernel's Duff frame), with the bounds of tests/test_fused.py.
3. The routing gate raises instead of rendering something else.
"""

import io
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

from gatling_tpu.cli import linear_to_srgb as jlinear_to_srgb
from gatling_tpu.cli import render_scene_file as jrender_scene_file
from gatling_tpu.render.fused import render_pixels_fused as jrender
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.integrator import default_dome
from gatling_tpu.utils.config import default_settings as jdefaults

from gatling_tpu_torch import cli, gi
from gatling_tpu_torch.imgio import encode_png
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.ops.bounce import from_jax_tables
from gatling_tpu_torch.render.camera import CameraUniforms
from gatling_tpu_torch.render.fused import render_pixels_fused
from gatling_tpu_torch.render.integrator import RenderConfig, Uniforms
from gatling_tpu_torch.scene.meshproc import build_triangulated_mesh
from gatling_tpu_torch.scene.stage import CameraDesc, MaterialDesc, MeshDesc, ShaderNode

from test_torch_bounce import CORNELL, jax_setup, rect_light


@pytest.mark.parametrize("nee", [False, True])
def test_render_pixels_fused_matches_jax(nee):
    w = h = 16
    spp = 2
    scene, static, juni = jax_setup(CORNELL, (rect_light(),) if nee else ())
    jcfg = JConfig(width=w, height=h, spp=spp, max_bounces=3, nee=nee, has_dome=False)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrender(jcfg, juni, scene, default_dome(), pix, spp, jnp.int32(5),
                                 static=static))

    cam = juni.camera
    uni = Uniforms(
        camera=CameraUniforms(torch.tensor(np.asarray(cam.position)),
                              torch.tensor(np.asarray(cam.forward)),
                              torch.tensor(np.asarray(cam.up)), float(cam.vfov),
                              0.0, 0.0, 0.0, float(cam.clip_start), float(cam.clip_end)),
        sample_offset=5, inv_total_sample_count=1.0, max_sample_value=10.0,
        rr_inv_min_term_prob=float(np.float32(0.95)), light_intensity_multiplier=1.0,
        meters_per_scene_unit=1.0, max_volume_walk_length=7)
    fs = from_jax_tables(np.asarray(scene.tris), np.asarray(scene.mats),
                         np.asarray(scene.lights), static.light_types, "cpu")
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=3, nee=nee)
    got = render_pixels_fused(cfg, uni, fs, torch.arange(w * h), spp, 5).numpy()

    assert got.shape == ref.shape == (w * h, 3)
    assert np.isfinite(got).all() and ref.mean() > 0.05
    rel = abs(got.mean() - ref.mean()) / ref.mean()
    close = (np.abs(got - ref) <= 1e-3 * np.maximum(1.0, np.abs(ref))).all(axis=1)
    print(f"nee={nee}: mean rel diff {rel:.2e}, {int((~close).sum())} of {w * h} pixels "
          "outside 1e-3")
    assert rel < 1e-3
    assert close.mean() >= 0.99


def _srgb8(img: np.ndarray) -> np.ndarray:
    rgb = np.clip(jlinear_to_srgb(img[::-1, :, :3]), 0, 1).astype(np.float32)
    return np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)


def test_cli_cpu_png_matches_jax_in_distribution(tmp_path):
    w = h = 24
    settings = dict(jdefaults(), spp=32, maxBounces=4)
    out = tmp_path / "cornell.png"
    assert cli.main([CORNELL, str(out), "--device", "cpu", "--image-width", str(w),
                     "--image-height", str(h), "--spp", "32", "--max-bounces", "4"]) == 0
    png = np.asarray(Image.open(io.BytesIO(out.read_bytes())))
    assert png.shape == (h, w, 3)

    port, scene = cli.render_scene_file(CORNELL, w, h, settings, device="cpu")
    np.testing.assert_array_equal(png, _srgb8(port))  # the PNG is this render
    assert scene.sample_offset == 32

    ref, _ = jrender_scene_file(CORNELL, w, h, settings)
    f, g = port[..., :3], ref[..., :3]
    assert np.isfinite(f).all() and (f >= 0).all()
    assert abs(f.mean() - g.mean()) / max(g.mean(), 1e-6) < 0.12
    fd = f.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3)).ravel()
    gd = g.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3)).ravel()
    assert np.corrcoef(fd, gd)[0, 1] > 0.95


def _quad_grid_mesh(n: int, material=None) -> MeshDesc:
    """An n x n grid of quads (2 n^2 triangles) in the z=0 plane."""
    xs = np.linspace(-1, 1, n + 1, dtype=np.float32)
    px, py = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([px.ravel(), py.ravel(), np.zeros(px.size, np.float32)], axis=1)
    i = np.arange(n)
    a = (i[:, None] * (n + 1) + i[None, :]).ravel()
    idx = np.stack([a, a + n + 1, a + n + 2, a + 1], axis=1).ravel()
    return MeshDesc(path="/grid", mesh=build_triangulated_mesh(pts, np.full(n * n, 4), idx),
                    transform=np.eye(4), material=material, double_sided=False, object_id=0)


def _render(scene, aov=AovId.COLOR, **settings):
    cam = CameraDesc(position=np.array([0, 0, 3], np.float32),
                     forward=np.array([0, 0, -1], np.float32),
                     up=np.array([0, 1, 0], np.float32), vfov=0.8)
    buf = gi.GiRenderBuffer(8, 8, 4)
    s = dict(jdefaults(), spp=1, maxBounces=2, **settings)
    gi.render(gi.GiRenderParams(scene=scene, camera=cam,
                                aov_bindings=[gi.GiAovBinding(aov, buf)], render_settings=s))
    return buf.data


def test_gate_renders_a_small_plain_scene():
    scene = gi.create_scene("cpu")
    scene.add_mesh(_quad_grid_mesh(4))
    img = _render(scene)
    assert np.isfinite(img).all() and scene.sample_offset == 1


def _with_volume(scene, path: str) -> None:
    """Give a rendered scene's lowered material an absorption coefficient,
    which only the MDL front end produces (the next frame re-reads it)."""
    scene._lowered_materials[scene._material_index[path]].params["volume_absorption"] = (
        1.0, 0.5, 0.2)


def test_gate_raises_on_large_scene():
    """Above the resident ceiling a plain scene renders through the walk,
    and so does a cutout material (the walk's cutout branch); a volume
    coefficient raises there, naming its ROADMAP item."""
    scene = gi.create_scene("cpu")
    scene.add_mesh(_quad_grid_mesh(46))  # 4232 triangles
    img = _render(scene)
    assert np.isfinite(img).all() and scene._fused_static.clustered
    scene = gi.create_scene("cpu")
    scene.add_mesh(_quad_grid_mesh(46, material="/cut"))
    node = ShaderNode(path="/cut/s", shader_id="UsdPreviewSurface", inputs={"opacity": 0.5},
                      input_connections={})
    scene.add_material(MaterialDesc(path="/cut", surface_node="/cut/s", nodes={"/cut/s": node}))
    img = _render(scene)
    assert np.isfinite(img).all() and scene._fused_static.clustered
    assert scene._fused_static.cutout and scene._fused.cutout
    _with_volume(scene, "/cut")
    with pytest.raises(NotImplementedError, match="USD content"):
        _render(scene)


@pytest.mark.parametrize("n", [2, 46])
def test_gate_raises_on_textured_material(n):
    """A base-colour texture renders through the split bounce, resident
    and clustered (a missing file reads as the 1x1 black fallback); a
    textured opacity still raises, naming its ROADMAP item."""
    for connected, textured_route in (("diffuseColor", True), ("opacity", False)):
        scene = gi.create_scene("cpu")
        scene.add_mesh(_quad_grid_mesh(n, material="/tex"))
        nodes = {
            "/tex/s": ShaderNode(path="/tex/s", shader_id="UsdPreviewSurface", inputs={},
                                 input_connections={connected: ("/tex/img", "rgb")}),
            "/tex/img": ShaderNode(path="/tex/img", shader_id="UsdUVTexture",
                                   inputs={"file": "albedo.png"}, input_connections={}),
        }
        scene.add_material(MaterialDesc(path="/tex", surface_node="/tex/s", nodes=nodes))
        if textured_route:
            img = _render(scene)
            assert np.isfinite(img).all() and scene._fused_static.textured
            assert scene._fused_static.clustered == (n == 46)
        else:
            with pytest.raises(NotImplementedError, match="First-hit AOVs, clipping and textured"):
                _render(scene)


@pytest.mark.parametrize("what", ["dome", "aov", "clipping", "devices", "vcolor"])
def test_gate_raises_outside_the_slice(what):
    scene = gi.create_scene("cpu")
    scene.add_mesh(_quad_grid_mesh(2))
    kwargs = {}
    if what == "vcolor":
        # a displayColor mesh whose fallback material multiplies the colours
        # in takes the wavefront integrator, which renders its cutout; a
        # volume coefficient raises there
        grid = scene.meshes[0]
        pts = np.zeros((9, 3), np.float32)
        pts[:, :2] = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], indexing="ij"), -1).reshape(9, 2)
        grid.mesh = build_triangulated_mesh(
            pts, np.full(4, 4), np.array([0, 3, 4, 1, 1, 4, 5, 2, 3, 6, 7, 4, 4, 7, 8, 5]),
            colors=np.array([[0.9, 0.2, 0.1]], np.float32))
        grid.material = "/dc"
        node = ShaderNode(path="/dc/s", shader_id="UsdPreviewSurface",
                          inputs={"_vcolor_multiply": True, "opacity": 0.5},
                          input_connections={})
        scene.add_material(MaterialDesc(path="/dc", surface_node="/dc/s", nodes={"/dc/s": node}))
    elif what == "dome":
        scene.set_dome_light(gi.GiDomeLight(file_path="sky.hdr"))
    elif what == "clipping":
        kwargs["clippingPlanes"] = True
    elif what == "devices":
        kwargs["parallelDevices"] = 2
    item = {"dome": "Dome lights", "aov": "First-hit AOVs", "clipping": "First-hit AOVs",
            "devices": "Multi-GPU", "vcolor": "USD content"}[what]
    if what == "vcolor":
        img = _render(scene)
        assert np.isfinite(img).all() and scene._accel is not None and scene._fused is None
        _with_volume(scene, "/dc")
    with pytest.raises(NotImplementedError, match=item):
        _render(scene, AovId.NORMAL if what == "aov" else AovId.COLOR, **kwargs)


def test_cuda_device_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        gi.create_scene("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([CORNELL, str(tmp_path / "x.png"), "--image-width", "8",
                  "--image-height", "8"])
    assert not os.path.exists(tmp_path / "x.png")


def test_blend_aovs_matches_jax():
    from gatling_tpu.render.integrator import FirstHitInfo, SampleResult
    from gatling_tpu.render.integrator import blend_aovs as jblend
    from gatling_tpu_torch.render.integrator import SampleResult as TSampleResult
    from gatling_tpu_torch.render.integrator import blend_aovs

    rng = np.random.default_rng(4)
    n, spp = 64, 4
    prev = rng.uniform(0, 2, size=(n, 4)).astype(np.float32)
    color = rng.uniform(0, 2, size=(n, 3)).astype(np.float32)
    z3 = jnp.zeros((n, 3), jnp.float32)
    zi = jnp.zeros((n,), jnp.int32)
    first = FirstHitInfo(normal=z3, albedo=z3, barycentrics=z3, texcoords=z3, tangents=z3,
                         bitangents=z3, depth=jnp.ones((n,), jnp.float32), object_id=zi,
                         face_id=zi, instance_id=zi, thin_walled=z3, double_sided=z3,
                         opacity=z3, nee=z3, hit=jnp.zeros((n,), bool))
    _scene, _static, juni0 = jax_setup(CORNELL)
    for offset in (0, 12):
        inv_total = float(np.float32(1.0 / (offset + spp)))
        juni = juni0._replace(sample_offset=jnp.int32(offset),
                             inv_total_sample_count=jnp.float32(inv_total))
        ref = jblend(JConfig(width=8, height=8, spp=spp), juni, {"color": jnp.asarray(prev)},
                     SampleResult(color=jnp.asarray(color), bounces=zi, first=first))
        uni = Uniforms(camera=None, sample_offset=offset, inv_total_sample_count=inv_total,
                       max_sample_value=10.0, rr_inv_min_term_prob=0.95,
                       light_intensity_multiplier=1.0, meters_per_scene_unit=1.0,
                       max_volume_walk_length=7)
        got = blend_aovs(RenderConfig(width=8, height=8, spp=spp), uni,
                         {"color": torch.tensor(prev)},
                         TSampleResult(torch.tensor(color), torch.zeros(n, dtype=torch.int32)))
        np.testing.assert_array_equal(got["color"].numpy(), np.asarray(ref["color"]))


def test_progressive_frames_add_up_to_one_frame():
    """Two progressive 1-spp frames through one GiScene equal one 2-spp
    frame: the sample index continues from sampleOffset."""
    def frames(spp, n):
        scene, desc, merged = cli.load_gi_scene(CORNELL, "cpu", {"maxBounces": 3, "spp": spp})
        buf = gi.GiRenderBuffer(8, 8, 4)
        params = gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                   aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                                   render_settings=merged)
        for _ in range(n):
            gi.render(params)
        return buf.data.copy(), scene.sample_offset

    two, off2 = frames(1, 2)
    one, off1 = frames(2, 1)
    assert off2 == off1 == 2
    np.testing.assert_allclose(two, one, rtol=1e-6, atol=1e-6)


def test_png_encoder_reads_back():
    img = np.random.default_rng(3).integers(0, 256, size=(5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(img)))), img)


def test_render_pixels_fused_instanced_matches_jax():
    """The port's sample loop over instance tables (tile swizzle, coherence
    sort, walk twin) against the JAX fused path in interpret mode on the
    same tables: the small instanced field, 8x8, 1 spp, 2 bounces, NEE."""
    from test_torch_clustered_bounce import CAMERAS, jax_tables, port_tables, uniforms

    w = h = 8
    scene, static = jax_tables("instanced_field", True, True)
    assert static.instanced
    juni = uniforms(*CAMERAS["instanced_field"])
    jcfg = JConfig(width=w, height=h, spp=1, max_bounces=2, nee=True, has_dome=False)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrender(jcfg, juni, scene, default_dome(), pix, 1, jnp.int32(3),
                                 static=static))
    cam = juni.camera
    uni = Uniforms(
        camera=CameraUniforms(torch.tensor(np.asarray(cam.position)),
                              torch.tensor(np.asarray(cam.forward)),
                              torch.tensor(np.asarray(cam.up)), float(cam.vfov),
                              0.0, 0.0, 0.0, float(cam.clip_start), float(cam.clip_end)),
        sample_offset=3, inv_total_sample_count=1.0, max_sample_value=10.0,
        rr_inv_min_term_prob=float(np.float32(0.95)), light_intensity_multiplier=1.0,
        meters_per_scene_unit=1.0, max_volume_walk_length=7)
    cfg = RenderConfig(width=w, height=h, spp=1, max_bounces=2, nee=True)
    got = render_pixels_fused(cfg, uni, port_tables(scene, static), torch.arange(w * h), 1,
                              3).numpy()
    assert got.shape == ref.shape == (w * h, 3)
    assert np.isfinite(got).all() and ref.mean() > 0.01
    rel = abs(got.mean() - ref.mean()) / ref.mean()
    close = (np.abs(got - ref) <= 1e-3 * np.maximum(1.0, np.abs(ref))).all(axis=1)
    print(f"instanced: mean rel diff {rel:.2e}, {int((~close).sum())} of {w * h} pixels "
          "outside 1e-3")
    assert rel < 1e-3
    assert close.mean() >= 0.99


def test_tile_swizzle_and_spp_replicas_compose():
    """A full frame of a clustered scene goes through the 32x32 tile order
    and the spp replicas; the result equals the same pixels rendered one
    sample at a time, unswizzled (per-ray results do not depend on order)."""
    from gatling_tpu_torch.scene.examples import sphere_field

    desc = sphere_field(n_side=6, sphere_res=8)
    scene = gi.create_scene("cpu")
    for m in desc.meshes:
        scene.add_mesh(m)
    for mat in desc.materials.values():
        scene.add_material(mat)
    for light in desc.lights:
        scene.add_light(light)
    w, h = 40, 36  # partial tiles on both axes

    def frame(spp, nee):
        buf = gi.GiRenderBuffer(w, h, 4)
        scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                    aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                                    render_settings=dict(spp=spp, maxBounces=3,
                                                         nextEventEstimation=nee)))
        return buf.data.copy()

    img = frame(2, True)
    assert scene._fused_static.instanced and scene._fused_static.n_instances == 38
    assert np.isfinite(img).all() and (img >= 0).all() and img[..., :3].mean() > 0.01
    # the same two samples through render_pixels_fused one at a time, on a
    # pixel subset (no tile swizzle) in reverse order
    from gatling_tpu_torch.render.camera import camera_uniforms
    cfg = RenderConfig(width=w, height=h, spp=1, max_bounces=3, nee=True)
    uni = Uniforms(camera=camera_uniforms(desc.first_camera(), False, "cpu"), sample_offset=0,
                   inv_total_sample_count=1.0, max_sample_value=10.0,
                   rr_inv_min_term_prob=float(np.float32(0.95)),
                   light_intensity_multiplier=1.0, meters_per_scene_unit=1.0,
                   max_volume_walk_length=7)
    pix = torch.arange(w * h - 1, -1, -1)
    one = sum(render_pixels_fused(cfg, uni, scene._fused, pix, 1, s) for s in (0, 1)) / 2
    one = one.flip(0).numpy().reshape(h, w, 3)
    np.testing.assert_allclose(img[..., :3], one, rtol=1e-5, atol=1e-6)


def test_sphere_field_renders_on_the_cpu():
    """gi.render of a small sphere_field through the twin: finite and
    non-negative, and NEE adds light."""
    from gatling_tpu_torch.scene.examples import sphere_field

    means = []
    for nee in (False, True):
        desc = sphere_field(n_side=2, sphere_res=8)
        scene = gi.create_scene("cpu")
        for m in desc.meshes:
            scene.add_mesh(m)
        for mat in desc.materials.values():
            scene.add_material(mat)
        for light in desc.lights:
            scene.add_light(light)
        buf = gi.GiRenderBuffer(16, 16, 4)
        gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                    aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                                    render_settings=dict(spp=2, maxBounces=3,
                                                         nextEventEstimation=nee)))
        assert np.isfinite(buf.data).all() and (buf.data >= 0).all()
        means.append(buf.data[..., :3].mean())
    assert means[1] > means[0] > 0.0
