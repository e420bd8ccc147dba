"""The port's dome light against the JAX package's.

1. `_quat_rotate` and `_sample_equirect` (render/integrator.py) against
   the JAX package's on seeded directions and a rotation: on a smooth dome
   within rtol 1e-5; on a dome with a sharp sun edge, where a last-bit
   difference of atan2 or acos moves a tap across the edge, within 1e-4
   relative on 99.9 % of rays;
2. the fused route's dome pass (render/fused.py dome_pass over the
   kernels' miss records) through `render_pixels_fused` on the CPU against
   the JAX package's `render_pixels_fused` in Pallas interpret mode: the
   Cornell box (open towards -y) under a gradient dome, rotated 30 degrees
   about the up axis with an emission multiplier, camera-visible and not,
   NEE off and on: 16x16, 2 spp, 3 bounces; per-pixel within 1e-3 on 99 %,
   the means within 1e-3, as test_torch_render.py holds the fused frame;
3. the wavefront's dome on the miss: `render_frame` against the JAX
   `render_frame` on the CPU (brute-force tracer), Cornell 32x32, 2 spp,
   4 bounces, NEE, every AOV, camera-visible and not: COLOR within 1e-3 on
   98 % of pixels, the means within 1 %;
4. the white furnace: a Lambertian sphere of albedo rho in a uniform dome
   of radiance L reflects rho L (tests/test_analytic_parity.py), through
   gi.render on both routes, within 1 %; the background sees L;
5. gi: `_params_key` follows the dome's rotation and emission (progressive
   accumulation resets), the C-style dome calls, a dome that fails to load
   renders black, and a USD DomeLight prim through the CLI.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gatling_tpu.render import integrator as jint
from gatling_tpu.render.fused import render_pixels_fused as jrender
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.lights import build_light_arrays as jlight_arrays
from gatling_tpu.render.material import build_materials as jbuild_materials
from gatling_tpu.render.material import lower_material as jlower_material
from gatling_tpu.render.integrator import render_frame as jrender_frame
from gatling_tpu.render.integrator import Accel as JAccel

from gatling_tpu_torch import cli, gi, imgio
from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT, AovId, aov_bit
from gatling_tpu_torch.ops.bounce import from_jax_tables
from gatling_tpu_torch.ops.geometry import pack_geometry
from gatling_tpu_torch.render import integrator as tint
from gatling_tpu_torch.render.camera import CameraUniforms
from gatling_tpu_torch.render.fused import render_pixels_fused
from gatling_tpu_torch.render.integrator import Accel, RenderConfig, Uniforms, render_frame
from gatling_tpu_torch.render.lights import build_light_arrays, light_tensors
from gatling_tpu_torch.render.material import build_materials, lower_material
from gatling_tpu_torch.scene.stage import CameraDesc, LightDesc
from gatling_tpu_torch.utils.config import default_settings

from test_torch_bounce import CORNELL, jax_setup, rect_light
from test_torch_wavefront import _cornell_geoms

# 30 degrees about the Cornell box's up axis (z)
ROTATION = (0.0, 0.0, float(np.sin(np.pi / 12)), float(np.cos(np.pi / 12)))
EMISSION = (1.5, 1.4, 1.3)


def _directions(n: int, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def smooth_dome(h: int = 32, w: int = 64) -> np.ndarray:
    """A sky gradient with a soft horizon band: no texel differs much from
    its neighbours."""
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
    return np.stack([0.4 + 0.5 * v, 0.5 + 0.3 * np.sin(2 * np.pi * u) ** 2,
                     1.0 - 0.6 * v], -1).astype(np.float32)


def sun_dome(h: int = 32, w: int = 64) -> np.ndarray:
    """The smooth dome with a 3x3-texel sun of 5e3."""
    tex = smooth_dome(h, w)
    tex[h // 4:h // 4 + 3, w // 3:w // 3 + 3] = 5e3
    return tex


@pytest.mark.parametrize("sun", [False, True])
def test_equirect_lookup_matches_jax(sun):
    tex = sun_dome() if sun else smooth_dome()
    n = 65536
    d = _directions(n, 1)
    q = np.asarray(ROTATION, np.float32)
    rot_j = np.asarray(jint._quat_rotate(jnp.asarray(q), jnp.asarray(d)))
    rot_t = tint._quat_rotate(torch.tensor(q), torch.tensor(d)).numpy()
    np.testing.assert_allclose(rot_t, rot_j, rtol=0, atol=1e-6)
    if sun:  # rays that look at the sun's texels
        centre = np.array([[np.cos(np.pi * 0.3), 0.8, np.sin(np.pi * 0.3)]], np.float32)
        d[: n // 4] = centre + 0.08 * _directions(n // 4, 2)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = np.asarray(jint._sample_equirect(jnp.asarray(tex), jnp.asarray(d)))
    got = tint._sample_equirect(torch.tensor(tex), torch.tensor(d)).numpy()
    if not sun:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
        return
    assert (ref > 100.0).any(axis=1).sum() > 100  # the sun was seen
    close = np.isclose(got, ref, rtol=1e-4, atol=0).all(axis=1)
    print(f"sun-edged dome: {int((~close).sum())} of {n} rays outside 1e-4")
    assert close.mean() >= 0.999


def _port_uniforms(juni, sample_offset: int) -> Uniforms:
    cam = juni.camera
    return Uniforms(
        camera=CameraUniforms(torch.tensor(np.asarray(cam.position)),
                              torch.tensor(np.asarray(cam.forward)),
                              torch.tensor(np.asarray(cam.up)), float(cam.vfov),
                              0.0, 0.0, 0.0, float(cam.clip_start), float(cam.clip_end)),
        sample_offset=sample_offset, inv_total_sample_count=1.0, max_sample_value=10.0,
        rr_inv_min_term_prob=float(np.float32(0.95)), light_intensity_multiplier=1.0,
        meters_per_scene_unit=1.0, max_volume_walk_length=7,
        dome_rotation=ROTATION, dome_emission_multiplier=EMISSION)


def _jax_dome(tex):
    return jint.DomeLightData(texture=jnp.asarray(tex), fallback=jnp.zeros((1, 1, 3)))


def _port_dome(tex):
    return tint.DomeLightData(texture=torch.tensor(tex), fallback=torch.zeros((1, 1, 3)))


@pytest.mark.parametrize("visible,nee", [(True, False), (False, False), (True, True)])
def test_fused_dome_pass_matches_jax(visible, nee):
    w = h = 16
    spp = 2
    scene, static, juni = jax_setup(CORNELL, (rect_light(),) if nee else ())
    juni = juni._replace(dome_rotation=jnp.asarray(ROTATION, jnp.float32),
                         dome_emission_multiplier=jnp.asarray(EMISSION, jnp.float32))
    tex = smooth_dome()
    jcfg = JConfig(width=w, height=h, spp=spp, max_bounces=3, nee=nee, has_dome=True,
                   dome_light_camera_visible=visible)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrender(jcfg, juni, scene, _jax_dome(tex), pix, spp, jnp.int32(5),
                                 static=static))

    fs = from_jax_tables(np.asarray(scene.tris), np.asarray(scene.mats),
                         np.asarray(scene.lights), static.light_types, "cpu")
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=3, nee=nee, has_dome=True,
                       dome_light_camera_visible=visible)
    uni = _port_uniforms(juni, 5)
    got = render_pixels_fused(cfg, uni, fs, torch.arange(w * h), spp, 5,
                              dome=_port_dome(tex)).numpy()
    dark = render_pixels_fused(dataclasses.replace(cfg, has_dome=False), uni, fs,
                               torch.arange(w * h), spp, 5).numpy()
    assert got.shape == ref.shape == (w * h, 3)
    assert np.isfinite(got).all() and got.mean() > dark.mean() * 1.05  # the dome lit the box
    rel = abs(got.mean() - ref.mean()) / ref.mean()
    close = (np.abs(got - ref) <= 1e-3 * np.maximum(1.0, np.abs(ref))).all(axis=1)
    print(f"visible={visible} nee={nee}: mean rel diff {rel:.2e}, {int((~close).sum())} of "
          f"{w * h} pixels outside 1e-3")
    assert rel < 1e-3
    assert close.mean() >= 0.99
    border = got.reshape(h, w, 3)[0]  # the frame's top row sees past the box
    if not visible:
        assert (border == 0.0).all(axis=1).any()


def _wavefront_case(visible: bool):
    w = h = 32
    spp, offset = 2, 3
    jdesc, tdesc, midx, jg, tg = _cornell_geoms()
    rows_j = [None] * len(midx)
    rows_t = [None] * len(midx)
    for p, i in midx.items():
        rows_j[i] = jlower_material(jdesc.materials.get(p) if p else None)
        rows_t[i] = lower_material(tdesc.materials.get(p) if p else None)
    jtable, jpool = jbuild_materials(rows_j)
    ttable, tpool = build_materials(rows_t)
    mask = sum(aov_bit(a) for a in AovId)
    _scene, _static, juni = jax_setup(CORNELL)
    juni = juni._replace(sample_offset=jnp.int32(offset),
                         inv_total_sample_count=jnp.float32(1.0 / (offset + spp)),
                         dome_rotation=jnp.asarray(ROTATION, jnp.float32),
                         dome_emission_multiplier=jnp.asarray(EMISSION, jnp.float32))
    aovs = {}
    for a in AovId:
        shape = (w * h,) if AOV_CHANNELS[a] == 1 else (w * h, AOV_CHANNELS[a])
        aovs[a.name.lower()] = np.full(shape, -1 if AOV_IS_INT[a] else 0,
                                       np.int32 if AOV_IS_INT[a] else np.float32)
    tex = smooth_dome()
    jcfg = JConfig(width=w, height=h, spp=spp, max_bounces=4, nee=True, has_dome=True,
                   dome_light_camera_visible=visible, aov_mask=mask, tracer="brute")
    ref = jrender_frame(jcfg, juni, jg, jtable, jlight_arrays([rect_light()]), _jax_dome(tex),
                        {k: jnp.asarray(v) for k, v in aovs.items()}, jpool, JAccel())
    uni = _port_uniforms(juni, offset)._replace(
        inv_total_sample_count=float(np.float32(1 / (offset + spp))))
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=4, nee=True, has_dome=True,
                       dome_light_camera_visible=visible, aov_mask=mask, tracer="brute")
    got = render_frame(cfg, uni, pack_geometry(tg, "cpu"), ttable.to("cpu"),
                       light_tensors(build_light_arrays([LightDesc(**vars(rect_light()))]), "cpu"),
                       {k: torch.as_tensor(v) for k, v in aovs.items()}, tpool, Accel(soup=tg),
                       _port_dome(tex))
    return np.asarray(ref["color"]), got["color"].numpy()


@pytest.mark.parametrize("visible", [True, False])
def test_wavefront_dome_matches_jax(visible):
    ref, got = _wavefront_case(visible)
    assert got.shape == ref.shape and np.isfinite(got).all()
    diff = np.abs(got - ref)
    frac = (diff <= 1e-3 + 1e-3 * np.abs(ref)).all(axis=1).mean()
    rel = abs(got[:, :3].mean() - ref[:, :3].mean()) / ref[:, :3].mean()
    print(f"visible={visible}: {frac:.4f} of pixels within 1e-3, mean rel diff {rel:.2e}")
    assert frac >= 0.98 and rel < 0.01


FURNACE_RHO, FURNACE_L = 0.6, 1.5
FURNACE_SETTINGS = dict(spp=64, maxBounces=3, rrBounceOffset=100, maxSampleValue=1000.0)


def _furnace_frame(pkg, sky: str, aovs=("COLOR",), **create):
    """(COLOR [16, 16, 3], the scene) of a Lambertian-coloured uv sphere
    (albedo FURNACE_RHO) under the uniform dome `sky`, rendered by the
    package `pkg` (the port's modules or the JAX package's, by name)."""
    gi_, stage, ex, meshproc, iface, config = pkg
    pts, counts, idx = ex._uv_sphere(32, 32)
    scene = gi_.create_scene(**create)
    scene.add_mesh(stage.MeshDesc(path="/s", mesh=meshproc.build_triangulated_mesh(pts, counts, idx),
                                  transform=np.eye(4), material="/m", double_sided=False,
                                  object_id=0))
    scene.add_material(ex._preview_material("/m", diffuseColor=(FURNACE_RHO,) * 3,
                                            roughness=1.0, metallic=0.0))
    gi_.giCreateDomeLight(scene, sky)
    cam = stage.CameraDesc(position=np.array([0, 0, 4.0], np.float32),
                           forward=np.array([0, 0, -1], np.float32),
                           up=np.array([0, 1, 0], np.float32), vfov=0.5)
    bufs = {}
    for name in aovs:
        a = iface.AovId[name]
        bufs[name] = gi_.GiRenderBuffer(16, 16, 1 if iface.AOV_IS_INT[a] else 4,
                                        iface.AOV_IS_INT[a])
    gi_.render(gi_.GiRenderParams(
        scene=scene, camera=cam,
        aov_bindings=[gi_.GiAovBinding(iface.AovId[n], b) for n, b in bufs.items()],
        render_settings=dict(config.default_settings(), **FURNACE_SETTINGS)))
    return np.asarray(bufs["COLOR"].data[..., :3]), scene


def _port_pkg():
    from gatling_tpu_torch import interface
    from gatling_tpu_torch.scene import examples, meshproc, stage
    from gatling_tpu_torch.utils import config

    return gi, stage, examples, meshproc, interface, config


@pytest.fixture(scope="module")
def furnace(tmp_path_factory):
    """The uniform sky, and the JAX package's furnace frame (its
    wavefront integrator on the CPU)."""
    from gatling_tpu import gi as jgi
    from gatling_tpu import interface as jiface
    from gatling_tpu.scene import examples as jex
    from gatling_tpu.scene import meshproc as jmeshproc
    from gatling_tpu.scene import stage as jstage
    from gatling_tpu.utils import config as jconfig

    sky = str(tmp_path_factory.mktemp("furnace") / "uniform.exr")
    imgio.write_image_file(sky, np.full((4, 8, 3), FURNACE_L, np.float32))
    ref, _ = _furnace_frame((jgi, jstage, jex, jmeshproc, jiface, jconfig), sky)
    return sky, ref


@pytest.mark.parametrize("aov", ["COLOR", "OBJECT_ID"])
def test_white_furnace(furnace, aov):
    """COLOR alone takes the fused route (K1's twin and the dome pass), an
    id AOV beside it the wavefront. The sphere's centre holds the JAX
    package's furnace value within 1 % and rho L within 4 %, the tolerance
    of tests/test_analytic_parity.py: the uber BSDF's Schlick term adds a
    few per cent at grazing angles to a Lambertian's rho."""
    sky, ref = furnace
    img, scene = _furnace_frame(_port_pkg(), sky, {"COLOR", aov}, device="cpu")
    assert (scene._fused is not None) == (aov == "COLOR")
    centre, ref_centre = img[4:12, 4:12].mean(axis=(0, 1)), ref[4:12, 4:12].mean(axis=(0, 1))
    print(f"{aov}: centre {centre}, the JAX package's {ref_centre}, rho L "
          f"{FURNACE_RHO * FURNACE_L}")
    np.testing.assert_allclose(centre, ref_centre, rtol=0.01)
    np.testing.assert_allclose(centre, [FURNACE_RHO * FURNACE_L] * 3, rtol=0.04)
    np.testing.assert_allclose(img[0, 0], [FURNACE_L] * 3, rtol=1e-6)  # the background sees L


def test_params_key_and_the_dome_calls(furnace, tmp_path):
    _img, scene = _furnace_frame(_port_pkg(), furnace[0], device="cpu")
    dome = scene.dome_light
    cam = CameraDesc(position=np.array([0, 0, 4.0], np.float32),
                     forward=np.array([0, 0, -1], np.float32),
                     up=np.array([0, 1, 0], np.float32), vfov=0.5)
    buf = gi.GiRenderBuffer(16, 16, 4)
    params = gi.GiRenderParams(scene=scene, camera=cam, aov_bindings=[gi.GiAovBinding(
        AovId.COLOR, buf)], render_settings=dict(default_settings(), spp=1, maxBounces=2))
    key = gi._params_key(params, 16, 16)
    gi.render(params)
    gi.render(params)
    assert scene.sample_offset == 2  # accumulating
    gi.giSetDomeLightRotation(dome, ROTATION)
    assert gi._params_key(params, 16, 16) != key
    gi.render(params)
    assert scene.sample_offset == 1  # the rotation reset the accumulation
    key = gi._params_key(params, 16, 16)
    gi.giSetDomeLightBaseEmission(dome, EMISSION)
    assert gi._params_key(params, 16, 16) != key
    gi.giSetDomeLightDiffuseSpecular(dome, 0.5, 0.25)  # stored, read by no shader
    assert (dome.diffuse, dome.specular) == (0.5, 0.25)
    gi.render(params)
    assert scene.sample_offset == 1
    np.testing.assert_allclose(buf.data[0, 0, :3], np.asarray(EMISSION) * FURNACE_L,
                               rtol=1e-6)  # the background: L times the emission
    # a dome file that fails to decode renders black (logged)
    bad = tmp_path / "bad.exr"
    bad.write_bytes(b"\x76\x2f\x31\x01 not an exr")
    gi.giCreateDomeLight(scene, str(bad))
    gi.render(params)
    assert (buf.data[0, 0, :3] == 0.0).all()


def test_cli_renders_a_dome_light_prim(tmp_path):
    """A DomeLight prim's inputs:texture:file is the dome; the frame
    differs from the dark one and writes as PNG and as linear EXR."""
    imgio.write_image_file(tmp_path / "sky.hdr", smooth_dome() * 2.0)
    usda = open(CORNELL).read().rstrip()
    assert usda.endswith("}")
    usda = usda[:-1] + ('    def DomeLight "Sky"\n    {\n'
                        '        asset inputs:texture:file = @sky.hdr@\n    }\n}\n')
    (tmp_path / "dome.usda").write_text(usda)
    args = ["--device", "cpu", "--image-width", "24", "--image-height", "24", "--spp", "2",
            "--max-bounces", "3"]
    assert cli.main([str(tmp_path / "dome.usda"), str(tmp_path / "dome.exr"), *args]) == 0
    assert cli.main([str(tmp_path / "dome.usda"), str(tmp_path / "dome.png"), *args]) == 0
    assert cli.main([CORNELL, str(tmp_path / "dark.exr"), *args]) == 0
    lit = imgio.load_image_file(tmp_path / "dome.exr")
    dark = imgio.load_image_file(tmp_path / "dark.exr")
    assert lit.dtype == np.float32 and lit.shape == (24, 24, 4)
    assert lit[..., :3].mean() > dark[..., :3].mean() * 1.05
    assert imgio.load_image_file(tmp_path / "dome.png").dtype == np.uint8
