"""The port's media on the CPU, beside tests/test_torch_volumes.py.

1. the resident twin (K1's) on the fog box (examples.cornell_fog: the
   Cornell box's tall block the MDL fog, its short block rough tinted
   glass, the bench's rect light) against the JAX `bounce_step` in the
   scatter mode with NEE, at bounce 0 and at bounce 4;
2. the port's wavefront `render_frame` against the JAX `render_frame`
   (the brute-force tracer on both sides) at mediumStackSize 0, 1 and 2 on
   a scattering slab and on the fog box: every pixel within 1e-3;
3. the seven checks of tests/test_volumes.py, each on the port's
   counterpart;
4. gi's routing of media (gatling_tpu/gi.py:687-698, :739-747), and the
   MDL-bound scenes through the CLI's loader.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gatling_tpu.render.material as jmat
import gatling_tpu.render.texture as jtex
from gatling_tpu.render.camera import CameraUniforms as JCameraUniforms
from gatling_tpu.render.integrator import Accel as JAccel
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.integrator import Uniforms as JUniforms
from gatling_tpu.render.integrator import default_dome
from gatling_tpu.render.integrator import render_frame as jrender_frame
from gatling_tpu.render.lights import build_light_arrays as jlight_arrays

from gatling_tpu_torch import cli
from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops.geometry import build_geometry, pack_geometry
from gatling_tpu_torch.render.camera import CameraUniforms
from gatling_tpu_torch.render.fused import render_pixels_fused
from gatling_tpu_torch.render.integrator import Accel, RenderConfig, Uniforms, render_frame, \
    render_pixels
from gatling_tpu_torch.render.lights import build_light_arrays, light_tensors
from gatling_tpu_torch.render.material import build_material_table, lower_material
from gatling_tpu_torch.render.texture import empty_pool
from gatling_tpu_torch.scene import examples as ex
from gatling_tpu_torch.scene.stage import load_scene

from test_torch_volumes import (FOG_BOX_CAMERA, ROUGH_GLASS, SLAB_CAMERA, _gi_fog,
                                check_resident_case, fog_box, fog_box_jax)  # noqa: F401
from test_volumes import _slab_scene


# ---------------------------------------------------------------------------
# 1. the fog box's resident bounce (K1's twin), scatter mode with NEE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bounce", [0, 4])
def test_fog_box_twin_matches_jax(fog_box, bounce):
    check_resident_case("fog_box_scatter", bounce, fog_box)


# ---------------------------------------------------------------------------
# 2. the wavefront's medium stack against the JAX render_frame
# ---------------------------------------------------------------------------

def _wavefront_pair(jgeom_, jtable, jlights, tgeom_, ttable, tlights, cam, stack, nee):
    """COLOR of one 16x16, 2-spp frame of the JAX and the port's
    render_frame (brute-force tracer), the same samples."""
    w = h = 16
    pos, fwd, vfov = cam
    fwd = np.asarray(fwd, np.float64) / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0]) if abs(fwd[1]) < 0.9 else np.array([0.0, 0.0, 1.0])
    up = up - fwd * (up @ fwd)
    up /= np.linalg.norm(up)
    vecs = [np.asarray(x, np.float32) for x in (pos, fwd, up)]
    jcfg = JConfig(width=w, height=h, spp=2, max_bounces=6, nee=nee, has_dome=False,
                   tracer="brute", has_volumes=True, medium_stack_size=stack)
    juni = JUniforms(
        camera=JCameraUniforms(*(jnp.asarray(v) for v in vecs), jnp.float32(vfov),
                               jnp.float32(0), jnp.float32(0), jnp.float32(0),
                               jnp.float32(0.01), jnp.float32(100)),
        sample_offset=jnp.int32(0), inv_total_sample_count=jnp.float32(0.5),
        max_sample_value=jnp.float32(10), rr_inv_min_term_prob=jnp.float32(0.95),
        light_intensity_multiplier=jnp.float32(1), meters_per_scene_unit=jnp.float32(1),
        max_volume_walk_length=jnp.int32(7), dome_rotation=jnp.asarray([0, 0, 0, 1.0]),
        dome_emission_multiplier=jnp.ones(3), dome_diffuse_specular=jnp.ones(2))
    aovs = {"color": np.zeros((w * h, 4), np.float32)}
    ref = np.asarray(jrender_frame(jcfg, juni, jgeom_, jtable, jlights, default_dome(),
                                   {k: jnp.asarray(v) for k, v in aovs.items()},
                                   jtex.empty_pool(), JAccel())["color"])
    cfg = RenderConfig(width=w, height=h, spp=2, max_bounces=6, nee=nee, tracer="brute",
                       has_volumes=True, medium_stack_size=stack)
    uni = Uniforms(camera=CameraUniforms(*(torch.as_tensor(v) for v in vecs), float(vfov),
                                         0.0, 0.0, 0.0, 0.01, 100.0),
                   sample_offset=0, inv_total_sample_count=0.5, max_sample_value=10.0,
                   rr_inv_min_term_prob=float(np.float32(0.95)),
                   light_intensity_multiplier=1.0, meters_per_scene_unit=1.0,
                   max_volume_walk_length=7)
    got = render_frame(cfg, uni, pack_geometry(tgeom_, "cpu"), ttable.to("cpu"),
                       light_tensors(tlights, "cpu"),
                       {k: torch.as_tensor(v) for k, v in aovs.items()},
                       empty_pool("cpu"), Accel(soup=tgeom_))["color"].numpy()
    return ref, got


def fog_box_port(path: str):
    """fog_box_jax on the port: its stage, builders and lowering."""
    desc = load_scene(path)
    paths = sorted({m.material for m in desc.meshes if m.material} | {"/glass"})
    for m in desc.meshes:
        if m.path.endswith("/ShortBlock"):
            m.material = "/glass"
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    rows = []
    for p in midx:
        row = lower_material(desc.materials.get(p) if p else None)
        if p == "/glass":
            row.params.update(ROUGH_GLASS)
        rows.append(row)
    return (build_geometry(desc.meshes, midx), build_material_table(rows),
            build_light_arrays(desc.lights))


@pytest.mark.parametrize("scene_name", ["fog_slab", "fog_box"])
@pytest.mark.parametrize("stack", [0, 1, 2])
def test_wavefront_media_match_jax(fog_box, scene_name, stack):
    if scene_name == "fog_slab":
        sigma_a, sigma_s, bias = (0.3, 0.3, 0.3), (0.7, 0.7, 0.7), -0.2
        jg, jt = _slab_scene(sigma_a)
        jt = jmat._pack_material_table(jt._replace(
            volume_scattering=jt.volume_scattering.at[0].set(jnp.asarray(sigma_s)),
            volume_bias=jt.volume_bias.at[0].set(bias)))
        jl, cam, nee = jlight_arrays([]), SLAB_CAMERA, False
        _desc, tg, tt = slab_tables(sigma_a, sigma_s, bias)
        tl = build_light_arrays([])
    else:
        jg, jt, jl = fog_box_jax(fog_box)
        tg, tt, tl = fog_box_port(fog_box)
        cam, nee = FOG_BOX_CAMERA, True
    np.testing.assert_array_equal(tt.packed_f, np.asarray(jt.packed_f))
    ref, got = _wavefront_pair(jg, jt, jl, tg, tt, tl, cam, stack, nee)
    diff = np.abs(got - ref)[:, :3].max(axis=-1)
    print(f"{scene_name} stack {stack}: max |diff| {diff.max():.3g}, mean {ref.mean():.4f}")
    assert np.isfinite(got).all() and ref.mean() > 0.01
    assert (diff <= 1e-3).all(), (scene_name, stack, int((diff > 1e-3).sum()))


# ---------------------------------------------------------------------------
# 3. tests/test_volumes.py's checks on the port
# ---------------------------------------------------------------------------

def slab_tables(sigma_a, sigma_s=(0.0, 0.0, 0.0), bias: float = 0.0):
    """The port's slab (examples.absorbing_slab): geometry, material table."""
    desc = ex.absorbing_slab(sigma_a, sigma_s, bias)
    midx = {"/glass": 0, "/wall": 1, None: 2}
    rows = [lower_material(desc.materials.get(p) if p else None) for p in midx]
    return desc, build_geometry(desc.meshes, midx), build_material_table(rows)


def test_port_slab_tables_match_jax():
    """examples.absorbing_slab builds tests/test_volumes.py's slab."""
    _desc, tg, tt = slab_tables((0.5, 1.0, 2.0))
    jg, jt = _slab_scene((0.5, 1.0, 2.0))
    np.testing.assert_array_equal(tt.packed_f, np.asarray(jt.packed_f))
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _slab_uniforms(desc):
    c = desc.first_camera()
    cam = CameraUniforms(*(torch.as_tensor(np.asarray(x, np.float32))
                           for x in (c.position, c.forward, c.up)), float(c.vfov), 0.0, 0.0,
                         0.0, 0.01, 100.0)
    return Uniforms(camera=cam, sample_offset=0, inv_total_sample_count=1.0,
                    max_sample_value=100.0, rr_inv_min_term_prob=float(np.float32(0.95)),
                    light_intensity_multiplier=1.0, meters_per_scene_unit=1.0,
                    max_volume_walk_length=7)


def _wavefront_slab(sigma_a, sigma_s, stack, spp=1, bounces=6):
    desc, geom, table = slab_tables(sigma_a, sigma_s)
    cfg = RenderConfig(width=8, height=8, spp=spp, max_bounces=bounces, jittered=False,
                       fis=False, has_volumes=True, medium_stack_size=stack,
                       rr_bounce_offset=100, tracer="brute")
    res = render_pixels(cfg, _slab_uniforms(desc), pack_geometry(geom, "cpu"), table.to("cpu"),
                        light_tensors(build_light_arrays([]), "cpu"), torch.arange(64), spp, 0,
                        empty_pool("cpu"), Accel(soup=geom))
    return res.color.numpy().reshape(8, 8, 3)


def _fused_slab(sigma_a, sigma_s, spp, bounces=6):
    desc, geom, table = slab_tables(sigma_a, sigma_s)
    fs, static = tb.build_fused_scene(geom, table, None, "cpu")
    fs, static = tb.with_volumes(fs, static, scatter=True)
    cfg = RenderConfig(width=8, height=8, spp=spp, max_bounces=bounces, jittered=False,
                       fis=False, has_volumes=True, medium_stack_size=1, rr_bounce_offset=100)
    img = render_pixels_fused(cfg, _slab_uniforms(desc), fs, torch.arange(64), spp, 0)
    return img.numpy().reshape(8, 8, 3)


@pytest.mark.parametrize("check_name", [
    "absorption_beer_lambert_stack0", "absorption_beer_lambert_stack2", "no_volume_passthrough",
    "scattering_medium_conserves_energy_roughly", "fused_scatter_absorption_parity",
    "fused_scatter_distribution_parity", "fused_scatter_walk_terminates"])
def test_volume_checks_on_the_port(check_name):
    """tests/test_volumes.py's seven checks, each on the port's counterpart:
    the wavefront's trace for the first four, render_pixels_fused with the
    scatter mode for the last three."""
    if check_name.startswith("absorption"):
        sigma = (0.5, 1.0, 2.0) if check_name.endswith("0") else (0.3, 0.6, 1.2)
        c = _wavefront_slab(sigma, (0.0, 0.0, 0.0), int(check_name[-1]))[4, 4]
        np.testing.assert_allclose(c, 2.0 * np.exp(-2.0 * np.asarray(sigma)), rtol=0.05)
    elif check_name == "no_volume_passthrough":
        c = _wavefront_slab((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0)[4, 4]
        np.testing.assert_allclose(c, [2.0, 2.0, 2.0], rtol=0.02)
    elif check_name == "scattering_medium_conserves_energy_roughly":
        img = _wavefront_slab((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 2, spp=8, bounces=12)
        assert np.isfinite(img).all() and (img >= 0).all() and img[4, 4].mean() < 2.0
    elif check_name == "fused_scatter_absorption_parity":
        sigma = (0.5, 1.0, 2.0)
        c = _fused_slab(sigma, (0.0, 0.0, 0.0), 1)[4, 4]
        np.testing.assert_allclose(c, 2.0 * np.exp(-2.0 * np.asarray(sigma)), rtol=0.05)
    elif check_name == "fused_scatter_distribution_parity":
        fused = _fused_slab((0.3, 0.3, 0.3), (0.7, 0.7, 0.7), 48, bounces=10)
        gen = _wavefront_slab((0.3, 0.3, 0.3), (0.7, 0.7, 0.7), 1, spp=48, bounces=10)
        assert np.isfinite(fused).all() and (fused >= 0).all()
        assert fused[4, 4].mean() < 2.0 * np.exp(-2.0 * 0.3) + 0.05
        rel = abs(fused.mean() - gen.mean()) / max(gen.mean(), 1e-6)
        assert rel < 0.2, (fused.mean(), gen.mean())
    else:
        img = _fused_slab((0.1, 0.1, 0.1), (5.0, 5.0, 5.0), 4, bounces=12)
        assert np.isfinite(img).all() and (img >= 0).all()



# ---------------------------------------------------------------------------
# 4. gi's routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stack,route,mode", [(0, "fused", tb.VOL_ABSORB),
                                              (1, "fused", tb.VOL_SCATTER),
                                              (2, "wavefront", None)])
def test_gi_routes_media_as_jax(fog_box, stack, route, mode):
    """gatling_tpu/gi.py:687-698, :739-747: absorption at stack 0 and the
    scatter mode at stack 1 on the fused kernels, deeper stacks on the
    wavefront."""
    scene, img = _gi_fog(fog_box, "fused", 8, 1, stack)
    assert np.isfinite(img).all()
    if route == "wavefront":
        assert scene._fused is None and scene._accel is not None
    else:
        assert scene._fused.volumes == mode and scene._fused_static.volumes
        assert scene._fused_static.scatter == (mode == tb.VOL_SCATTER)


def test_mdl_scenes_render_through_the_cli(tmp_path):
    """glass_tinted and cornell_fog as the CLI loads them: the MDL
    sourceAsset resolved (OmniGlass from the port's bundled modules, the
    fog beside the file), routed as JAX routes them."""
    for make, stack, mode in ((ex.glass_tinted, 0, tb.VOL_ABSORB),
                              (ex.cornell_fog, 1, tb.VOL_SCATTER)):
        img, scene = cli.render_scene_file(make(str(tmp_path)), 8, 8,
                                           {"spp": 1, "maxBounces": 4,
                                            "nextEventEstimation": True,
                                            "mediumStackSize": stack}, device="cpu")
        assert np.isfinite(img).all() and img[..., :3].max() > 0.0
        assert scene._fused.volumes == mode and scene._fused_static.advanced


@pytest.mark.parametrize("case", ["textured_scatter", "many_materials"])
def test_gi_sends_unfit_scatter_to_the_wavefront(tmp_path, case):
    """scatter_fits (gatling_tpu/gi.py:691-695): at mediumStackSize 1 a
    scattering medium in a textured scene, or more than 63 materials,
    takes the wavefront; at stack 0 the same scenes stay fused."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId

    if case == "textured_scatter":
        desc = ex.interior(detail=1, tex_dir=str(tmp_path))
        desc.materials["/m_bowl"] = ex.fog_material("/m_bowl", str(tmp_path))
    else:
        desc = ex.sphere_field(n_side=9, sphere_res=6)
        for i, m in enumerate(desc.meshes):
            if m.instance_transforms is not None:  # one material a placement: 81 + 2
                for k, xf in enumerate(m.instance_transforms):
                    path = f"/glass{i}_{k}"
                    desc.materials[path] = ex.tinted_glass_material(path)
                    desc.meshes.append(type(m)(path=f"{m.path}_{k}", mesh=m.mesh,
                                               transform=xf, material=path,
                                               double_sided=False, object_id=100 + k))
                m.instance_transforms = None
        desc.materials["/ground"] = ex.fog_material("/ground", str(tmp_path))
    for stack, wavefront in ((1, True), (0, False)):
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
                                    render_settings=dict(spp=1, maxBounces=2,
                                                         mediumStackSize=stack)))
        assert np.isfinite(buf.data).all()
        assert (scene._fused is None) == wavefront, (case, stack)
