"""MDL backface materials in the port against the JAX package.

A material whose MDL source has a `backface:` surface lowers its
parameters into `LoweredMaterial.backface`; `build_material_table`
appends a row of them, and the wavefront integrator shades a back-facing
hit with it (`RenderConfig.has_backface`; packed_i column
MI_BACKFACE_ID). Held against the JAX package (tests/test_backface.py's
fixture, two_face):

1. the lowering: the front parameters, the backface dict and the traits
   equal, bit for bit as floats;
2. the table of [two_face, plain]: packed_f bit for bit, packed_i equal,
   MI_BACKFACE_ID [2, 1, 2], the appended row the backface's colour and
   no emission;
3. the furnace of tests/test_backface.py:86 (a double-sided Lambertian
   plane under a uniform dome, 8x8, 64 spp, 2 bounces, seen from the
   front and from behind) through the port's render_pixels and the JAX
   render_pixels, the same samples: every pixel within 1e-3 (relative and
   absolute) on 98 % of pixels and the means within 1 % (the whole-frame
   tolerances of tests/test_torch_wavefront.py), and the centre's albedo
   the front's or the backface's within the JAX test's rtol 0.08;
4. gi's route: a backface surface takes the wavefront, COLOR alone too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatling_tpu.interface import empty_light_arrays as jempty_lights
from gatling_tpu.ops.geometry import build_geometry as jbuild_geometry
from gatling_tpu.render.camera import CameraUniforms as JCameraUniforms
from gatling_tpu.render.integrator import DomeLightData as JDome
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.integrator import Uniforms as JUniforms
from gatling_tpu.render.integrator import render_pixels as jrender_pixels
from gatling_tpu.render import material as jmat
from gatling_tpu.render import mdl as jmdl
from gatling_tpu.scene import meshproc as jmeshproc
from gatling_tpu.scene import stage as jstage

from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId, aov_bit, empty_light_arrays
from gatling_tpu_torch.ops.geometry import build_geometry, pack_geometry
from gatling_tpu_torch.render import material as tmat
from gatling_tpu_torch.render import mdl as tmdl
from gatling_tpu_torch.render.camera import CameraUniforms
from gatling_tpu_torch.render.integrator import (
    Accel,
    DomeLightData,
    RenderConfig,
    Uniforms,
    render_pixels,
)
from gatling_tpu_torch.render.lights import light_tensors
from gatling_tpu_torch.render.texture import empty_pool
from gatling_tpu_torch.scene import meshproc, stage

from test_torch_bvh import one_thread  # noqa: F401 (an autouse fixture)

TWO_FACE_MDL = """
mdl 1.6;
import ::df::*;
export material two_face(color front_tint = color(0.7, 0.2, 0.1))
 = material(
    thin_walled: true,
    ior: color(1.0),
    surface: material_surface(
        scattering: df::diffuse_reflection_bsdf(tint: front_tint)
    ),
    backface: material_surface(
        scattering: df::diffuse_reflection_bsdf(tint: color(0.1, 0.3, 0.8))
    )
);
"""


def _two_face(tmp_path):
    """(JAX, port) lowerings of tests/test_backface.py's two_face."""
    p = tmp_path / "two_face.mdl"
    p.write_text(TWO_FACE_MDL)
    return (jmat.lower_material(jmdl.load_mdl_material(p, "two_face")),
            tmat.lower_material(tmdl.load_mdl_material(p, "two_face")))


def _same_floats(a, b):
    return np.array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))


def test_backface_lowering_matches_jax(tmp_path):
    jrow, trow = _two_face(tmp_path)
    assert trow.traits.has_backface_bsdf and jrow.traits.has_backface_bsdf
    assert trow.traits.has_backface_edf == jrow.traits.has_backface_edf
    assert set(trow.params) == set(jrow.params) and set(trow.backface) == set(jrow.backface)
    for k, v in trow.params.items():
        assert _same_floats(v, jrow.params[k]), k
    for k, v in trow.backface.items():
        assert _same_floats(v, jrow.backface[k]), k
    np.testing.assert_allclose(trow.backface["base_color"], (0.1, 0.3, 0.8), atol=1e-6)


def test_backface_table_matches_jax(tmp_path):
    jrow, trow = _two_face(tmp_path)
    jt = jmat.build_material_table([jrow, jmat.lower_material(None)])
    tt = tmat.build_material_table([trow, tmat.lower_material(None)])
    assert tt.count == 3
    np.testing.assert_array_equal(tt.packed_f.view(np.int32), np.asarray(jt.packed_f).view(np.int32))
    np.testing.assert_array_equal(tt.packed_i, np.asarray(jt.packed_i))
    assert list(tt.packed_i[:, tmat.MI_BACKFACE_ID]) == [2, 1, 2]
    np.testing.assert_allclose(tt.packed_f[2, tmat.MF_BASE:tmat.MF_BASE + 3], (0.1, 0.3, 0.8),
                               atol=1e-6)
    assert (tt.packed_f[2, tmat.MF_EMISSIVE:tmat.MF_EMISSIVE + 3] == 0).all()


def _plane(pkg):
    stage_, meshproc_ = pkg
    pts = np.array([[-50, -50, 0], [50, -50, 0], [-50, 50, 0], [50, 50, 0]], np.float32)
    mesh = meshproc_.build_triangulated_mesh(pts, np.array([4]), np.array([0, 1, 3, 2]))
    return stage_.MeshDesc(path="/p", mesh=mesh, transform=np.eye(4), material="m",
                           double_sided=True, object_id=0)


def _juniforms(pos, forward):
    return JUniforms(
        camera=JCameraUniforms(
            position=jnp.asarray(pos, jnp.float32), forward=jnp.asarray(forward, jnp.float32),
            up=jnp.asarray([0.0, 1.0, 0.0], jnp.float32), vfov=jnp.float32(0.5),
            lens_radius=jnp.float32(0), focus_distance=jnp.float32(0),
            sensor_exposure=jnp.float32(0), clip_start=jnp.float32(0.01),
            clip_end=jnp.float32(1000.0)),
        sample_offset=jnp.int32(0), inv_total_sample_count=jnp.float32(1.0),
        max_sample_value=jnp.float32(100.0), rr_inv_min_term_prob=jnp.float32(0.95),
        light_intensity_multiplier=jnp.float32(1.0), meters_per_scene_unit=jnp.float32(1.0),
        max_volume_walk_length=jnp.int32(7), dome_rotation=jnp.asarray([0, 0, 0, 1.0]),
        dome_emission_multiplier=jnp.ones(3), dome_diffuse_specular=jnp.ones(2))


def _uniforms(pos, forward):
    def t3(v):
        return torch.tensor(np.asarray(v, np.float32))

    return Uniforms(camera=CameraUniforms(t3(pos), t3(forward), t3([0.0, 1.0, 0.0]), 0.5, 0.0,
                                          0.0, 0.0, float(np.float32(0.01)), 1000.0),
                    sample_offset=0, inv_total_sample_count=1.0, max_sample_value=100.0,
                    rr_inv_min_term_prob=float(np.float32(0.95)),
                    light_intensity_multiplier=1.0, meters_per_scene_unit=1.0,
                    max_volume_walk_length=7)


def furnace_pair(jrow, trow, views, spp: int = 64, jax_config=None, port_config=None,
                 mesh_pkgs=None, jax_primvars=None, port_primvars=None):
    """The furnace frames of tests/test_backface.py (8x8, `spp` samples, 2
    bounces, unjittered, a uniform dome of 1, no roulette) of a plane bound
    to the lowered material (jrow, trow) beside the default material, from
    each camera (position, forward) of `views`: [(JAX [64, 3], port [64,
    3])]. `mesh_pkgs` builds the meshes (JAX's, the port's) from each
    package's (stage, meshproc)."""
    make = mesh_pkgs or (lambda pkg: [_plane(pkg)])
    jmeshes, tmeshes = make((jstage, jmeshproc)), make((stage, meshproc))
    jgeom = jbuild_geometry(jmeshes, {"m": 0, None: 1})
    tgeom = build_geometry(tmeshes, {"m": 0, None: 1})
    jtable = jmat.build_material_table([jrow, jmat.lower_material(None)])
    ttable = tmat.build_material_table([trow, tmat.lower_material(None)]).to("cpu")
    jdome = JDome(texture=jnp.full((1, 1, 3), 1.0, jnp.float32),
                  fallback=jnp.zeros((1, 1, 3), jnp.float32))
    dome = DomeLightData(texture=torch.ones((1, 1, 3)), fallback=torch.zeros((1, 1, 3)))
    settings = dict(width=8, height=8, spp=spp, max_bounces=2, jittered=False, fis=False,
                    has_dome=True, rr_bounce_offset=100)
    jcfg = JConfig(**settings, **(jax_config or {}))
    cfg = RenderConfig(**settings, **(port_config or {}))
    pix = np.arange(64, dtype=np.int32)
    out = []
    for pos, forward in views:
        ref = jrender_pixels(jcfg, _juniforms(pos, forward), jgeom, jtable, jempty_lights(),
                             jdome, jnp.asarray(pix), spp, jnp.int32(0),
                             instance_primvars=jax_primvars).color
        got = render_pixels(cfg, _uniforms(pos, forward), pack_geometry(tgeom, "cpu"), ttable,
                            light_tensors(empty_light_arrays(), "cpu"), torch.as_tensor(pix),
                            spp, 0, empty_pool("cpu"), Accel(soup=tgeom), dome,
                            port_primvars).color
        out.append((np.asarray(ref), got.numpy()))
    return out


def assert_frames_close(got, ref, label):
    """tests/test_torch_wavefront.py's whole-frame tolerances: every
    channel within 1e-3 + 1e-3 |ref| on 98 % of pixels, the means within
    1 %."""
    close = (np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref)).all(axis=-1).mean()
    rel = abs(got.mean() - ref.mean()) / ref.mean()
    print(f"{label}: {close:.4f} of pixels within 1e-3, mean rel diff {rel:.2e}")
    assert close >= 0.98 and rel < 0.01, label


def test_backface_furnace_matches_jax(tmp_path):
    """tests/test_backface.py:86 through both integrators: the front sees
    the front albedo, the back the backface's."""
    jrow, trow = _two_face(tmp_path)
    jrow.params["thin_walled"] = trow.params["thin_walled"] = 0
    (jf, tf), (jb, tb) = furnace_pair(jrow, trow, (([0, 0, 4.0], [0, 0, -1]),
                                                   ([0, 0, -4.0], [0, 0, 1])),
                                      jax_config=dict(has_backface=True),
                                      port_config=dict(has_backface=True))
    for got, ref, albedo, label in ((tf, jf, (0.7, 0.2, 0.1), "front"),
                                    (tb, jb, (0.1, 0.3, 0.8), "back")):
        assert_frames_close(got, ref, label)
        centre = got.reshape(8, 8, 3)[2:6, 2:6].mean(axis=(0, 1))
        np.testing.assert_allclose(centre, albedo, rtol=0.08)


def test_gi_routes_backface_to_wavefront(tmp_path):
    """A backface surface takes the wavefront even for COLOR alone; under a
    uniform dome the plane seen from behind is the backface's blue, from
    the front the front's red."""
    from gatling_tpu_torch import imgio

    p = tmp_path / "two_face.mdl"
    p.write_text(TWO_FACE_MDL)
    sky = str(tmp_path / "uniform.exr")
    imgio.write_image_file(sky, np.ones((4, 8, 3), np.float32))
    centres = []
    for z in (4.0, -4.0):
        scene = gi.create_scene("cpu")
        scene.add_mesh(_plane((stage, meshproc)))
        desc = tmdl.load_mdl_material(p, "two_face", name="m")
        scene.add_material(stage.MaterialDesc(path="m", surface_node=desc.surface_node,
                                              nodes=desc.nodes, base_dir=desc.base_dir))
        gi.giCreateDomeLight(scene, sky)
        cam = stage.CameraDesc(position=np.array([0, 0, z], np.float32),
                               forward=np.array([0, 0, -np.sign(z)], np.float32),
                               up=np.array([0, 1, 0], np.float32), vfov=0.5)
        buf = gi.GiRenderBuffer(8, 8, 4)
        params = gi.GiRenderParams(scene=scene, camera=cam, aov_bindings=[gi.GiAovBinding(
            AovId.COLOR, buf)], render_settings=dict(spp=16, maxBounces=2, rrBounceOffset=100))
        gi.render(params)
        assert scene._accel is not None and scene._fused is None
        assert gi._build_config(params, 8, 8, aov_bit(AovId.COLOR)).has_backface
        assert scene._material_table.count == len(scene._lowered_materials) + 1
        assert np.isfinite(buf.data).all()
        centres.append(buf.data[2:6, 2:6, :3].mean(axis=(0, 1)))
    front, back = centres
    print(f"front {front}, back {back}")
    assert front[0] > 2 * front[2] and back[2] > 2 * back[0]
