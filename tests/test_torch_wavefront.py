"""The port's wavefront integrator against the JAX package's.

Inputs are made with numpy from seeds and handed to both sides:

1. `bsdf.sample` / `evaluate` / `auxiliary` on every lobe (diffuse, metal,
   specular workflow, thin and thick transmission, clearcoat, anisotropy,
   all mixed): outputs within rtol 1e-4 / atol 1e-5 and events equal on
   99.5 % of rays (XLA's and PyTorch's cos/sin/sqrt differ in the last
   bits, which can move a sample across a lobe boundary);
2. `sample_light` for each of the four light types and all four mixed,
   within the same tolerance on 99.9 % of rays;
3. `_shading_state` on random hits of the Cornell box, within 1e-5;
4. `render_frame(tracer="brute")` against the JAX `render_frame` on the
   Cornell box, 32x32, 2 spp, 4 bounces, NEE, every AOV: the ids and
   barycentrics equal on 99 % of pixels, COLOR and the float AOVs within
   1e-3 on 98 % and the mean within 1 % (the same RNG streams; a ray that
   grazes an edge can take another path);
5. `gi.render` of the committed graphical scenes `Render.AOVs` and
   `Mesh.PrimvarInterpolation` on the CPU (K5/K6's twins) against their
   reference PNGs, at each scene's own gtl:errorPixelThreshold and
   gtl:flipThreshold (the JAX package's harness and FLIP do the encoding
   and the comparison);
6. gi's routing: the wavefront for AOVs outside FUSED_AOV_MASK and for
   vertex colours, the fused kernels for COLOR; NotImplementedError above
   8192 triangles, for cutout and for volumes; clipping planes, the CLI's
   integer AOVs, transform edits and progressive frames.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gatling_tpu import imgio as jimgio
from gatling_tpu.flip import mean_flip
from gatling_tpu.ops.geometry import build_geometry as jbuild_geometry
from gatling_tpu.ops.intersect import Hit as JHit
from gatling_tpu.render import bsdf as jbsdf
from gatling_tpu.render.camera import CameraUniforms as JCameraUniforms
from gatling_tpu.render.integrator import Accel as JAccel
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.integrator import Uniforms as JUniforms
from gatling_tpu.render.integrator import _shading_state as jshading_state
from gatling_tpu.render.integrator import default_dome
from gatling_tpu.render.integrator import render_frame as jrender_frame
from gatling_tpu.render.lights import build_light_arrays as jlight_arrays
from gatling_tpu.render.lights import sample_light as jsample_light
from gatling_tpu.render.material import build_materials as jbuild_materials
from gatling_tpu.render.material import lower_material as jlower_material
from gatling_tpu.scene.stage import LightDesc as JLightDesc
from gatling_tpu.scene.stage import load_scene as jload_scene
from gatling_tpu.scene.usda import load_usd
from gatling_tpu.testing import _encode_srgb_u8, compute_render_spec

from gatling_tpu_torch import cli, gi
from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT, AovId, aov_bit
from gatling_tpu_torch.ops.geometry import build_geometry, pack_geometry
from gatling_tpu_torch.ops.intersect import Hit
from gatling_tpu_torch.ops.trace import build_trace_tables
from gatling_tpu_torch.render import bsdf
from gatling_tpu_torch.render.camera import CameraUniforms
from gatling_tpu_torch.render.integrator import (
    Accel,
    RenderConfig,
    Uniforms,
    _shading_state,
    render_frame,
)
from gatling_tpu_torch.render.lights import build_light_arrays, light_tensors, sample_light
from gatling_tpu_torch.render.material import build_materials, lower_material
from gatling_tpu_torch.scene.meshproc import build_triangulated_mesh
from gatling_tpu_torch.scene.stage import (
    CameraDesc,
    LightDesc,
    MaterialDesc,
    ShaderNode,
    load_scene,
)

from test_torch_bounce import CORNELL, rect_light
from test_torch_render import _quad_grid_mesh

GRAPHICAL = Path(__file__).parent / "graphical"
RTOL, ATOL = 1e-4, 1e-5


def _frac_close(got, ref, rtol=RTOL, atol=ATOL) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    close = np.isclose(got, ref, rtol=rtol, atol=atol)
    return float(close.reshape(close.shape[0], -1).all(axis=1).mean())


# ---------------------------------------------------------------------------
# 1. the uber-BSDF
# ---------------------------------------------------------------------------

LOBES = ("diffuse", "metal", "specular_workflow", "thin_transmission", "thick_transmission",
         "clearcoat", "anisotropic", "mixed")


def _bsdf_inputs(lobe: str, n: int = 4096, seed: int = 0):
    """numpy parameter columns of one lobe, a shading frame, wo, wi, xi and
    the facing of n rays."""
    rng = np.random.default_rng(seed + LOBES.index(lobe))
    u = lambda lo=0.0, hi=1.0: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    z = np.zeros(n, np.float32)
    p = dict(base_color=rng.uniform(0, 1, (n, 3)).astype(np.float32), metallic=z.copy(),
             roughness=u(0.05, 1.0), ior=u(1.2, 2.0), opacity=np.ones(n, np.float32),
             opacity_threshold=z.copy(), emissive=np.zeros((n, 3), np.float32),
             use_specular_workflow=z.copy(), specular_color=np.zeros((n, 3), np.float32),
             transmission=z.copy(), thin_walled=np.zeros(n, bool),
             volume_absorption=np.zeros((n, 3), np.float32),
             volume_scattering=np.zeros((n, 3), np.float32), volume_bias=z.copy(),
             backface_edf=z.copy(), clearcoat=z.copy(), clearcoat_roughness=u(0.05, 0.5),
             anisotropy=z.copy(), anisotropy_rotation=z.copy())
    if lobe in ("metal", "mixed"):
        p["metallic"] = np.ones(n, np.float32) if lobe == "metal" else u()
    if lobe in ("specular_workflow", "mixed"):
        p["use_specular_workflow"] = (u() > 0.5).astype(np.float32) if lobe == "mixed" \
            else np.ones(n, np.float32)
        p["specular_color"] = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if lobe in ("thin_transmission", "thick_transmission", "mixed"):
        p["transmission"] = u(0.3, 1.0)
        p["thin_walled"] = (np.ones(n, bool) if lobe == "thin_transmission"
                            else u() > 0.5 if lobe == "mixed" else np.zeros(n, bool))
    if lobe in ("clearcoat", "mixed"):
        p["clearcoat"] = u(0.2, 1.0)
    if lobe in ("anisotropic", "mixed"):
        p["anisotropy"], p["anisotropy_rotation"] = u(0.1, 1.0), u()
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tan = np.cross(nrm, rng.normal(size=(n, 3)))
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    bit = np.cross(nrm, tan)

    def unit(sign):
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        s = np.where(rng.uniform(size=n) < 0.9, 1.0, -1.0) if sign else 1.0
        return v * np.sign((v * nrm).sum(1))[:, None] * np.asarray(s)[..., None]

    frame = [a.astype(np.float32) for a in (nrm, tan, bit, unit(True), unit(True))]
    xi = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    front = rng.uniform(size=n) < 0.7
    return p, frame, xi, front


@pytest.mark.parametrize("lobe", LOBES)
def test_bsdf_matches_jax(lobe):
    p, (n, t, b, wo, wi), xi, front = _bsdf_inputs(lobe)
    jp = jbsdf.BsdfParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = bsdf.BsdfParams(**{k: torch.as_tensor(v) for k, v in p.items()})
    J, T = (lambda *a: [jnp.asarray(x) for x in a]), (lambda *a: [torch.as_tensor(x) for x in a])

    ref = jbsdf.sample(jp, *J(wo, n, t, b, xi), front=jnp.asarray(front))
    got = bsdf.sample(tp, *T(wo, n, t, b, xi), front=torch.as_tensor(front))
    ev = got[2].numpy() == np.asarray(ref[2])
    print(f"{lobe}: events {np.bincount(got[2].numpy())}, {int((~ev).sum())} differ")
    assert ev.mean() >= 0.995 and got[2].dtype == torch.int32
    for k, (g, r) in enumerate(zip(got, ref)):
        if k != 2:
            assert _frac_close(g, r) >= 0.995, (lobe, "sample", k)
    for k, (g, r) in enumerate(zip(bsdf.evaluate(tp, *T(wo, wi, n, t, b)),
                                   jbsdf.evaluate(jp, *J(wo, wi, n, t, b)))):
        assert _frac_close(g, r) >= 0.995, (lobe, "evaluate", k)
    assert _frac_close(bsdf.auxiliary(tp, *T(wo, n)), jbsdf.auxiliary(jp, *J(wo, n))) >= 0.999
    np.testing.assert_array_equal(bsdf.cutout_opacity(tp).numpy(),
                                  np.asarray(jbsdf.cutout_opacity(jp)))


# ---------------------------------------------------------------------------
# 2. light sampling
# ---------------------------------------------------------------------------

def _light_params(kind: str) -> dict:
    p = dict(intensity=5.0, exposure=0.5, color=np.array([1.0, 0.8, 0.6], np.float32),
             normalize=True, diffuse=0.9, specular=0.7, enableColorTemperature=False,
             colorTemperature=6500.0)
    p.update(dict(sphere=dict(radius=0.3), distant=dict(angle=5.0),
                  rect=dict(width=0.8, height=0.5), disk=dict(radius=0.4))[kind])
    return p


def _lights(kind: str, cls):
    kinds = ("sphere", "distant", "rect", "disk") if kind == "all" else (kind,)
    out = []
    for i, k in enumerate(kinds):
        xf = np.eye(4)
        xf[3, :3] = [0.3 * i, 2.0, 0.1]
        out.append(cls(path=f"/{k}", light_type=k, transform=xf, params=_light_params(k)))
    return out


@pytest.mark.parametrize("kind", ["sphere", "distant", "rect", "disk", "all"])
def test_sample_light_matches_jax(kind):
    rng = np.random.default_rng(5)
    k4 = rng.uniform(0, 1, (2048, 4)).astype(np.float32)
    pos = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    ref = jsample_light(jlight_arrays(_lights(kind, JLightDesc)), jnp.asarray(k4),
                        jnp.asarray(pos), jnp.float32(1.5), jnp.float32(0.5))
    got = sample_light(light_tensors(build_light_arrays(_lights(kind, LightDesc)), "cpu"),
                       torch.as_tensor(k4), torch.as_tensor(pos), 1.5, 0.5)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert _frac_close(g, r) >= 0.999, (kind, k)
    assert float(got[2].abs().sum()) > 0


# ---------------------------------------------------------------------------
# 3. the shading state
# ---------------------------------------------------------------------------

def _cornell_geoms():
    jdesc, tdesc = jload_scene(CORNELL), load_scene(CORNELL)
    paths = sorted({m.material for m in jdesc.meshes if m.material})
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    return jdesc, tdesc, midx, jbuild_geometry(jdesc.meshes, midx), build_geometry(tdesc.meshes,
                                                                                   midx)


def test_shading_state_matches_jax():
    _jd, _td, _midx, jg, tg = _cornell_geoms()
    rng = np.random.default_rng(9)
    n = 1024
    tri = rng.integers(0, 32, n).astype(np.int32)
    tri[::10] = -1  # misses read triangle 0
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = (rng.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    t = np.ones(n, np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = jshading_state(jg, JHit(*(jnp.asarray(x) for x in (t, tri, u, v))), jnp.asarray(d))
    hit = Hit(*(torch.as_tensor(x) for x in (t, tri, u, v)))
    got = _shading_state(pack_geometry(tg, "cpu"), hit, torch.as_tensor(d))
    for key, r in ref.items():
        g = got[key].numpy()
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, key
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(g, r, err_msg=key)


# ---------------------------------------------------------------------------
# 4. a whole frame against the JAX render_frame
# ---------------------------------------------------------------------------

ALL_AOVS = tuple(AovId)
INT_KEYS = ("object_id", "face_id", "instance_id")


def test_render_frame_brute_matches_jax():
    """Cornell 32x32, 2 spp, 4 bounces, NEE with the rect light, every AOV,
    both with the brute-force Moller-Trumbore tracer."""
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
    mask = sum(aov_bit(a) for a in ALL_AOVS)
    cam = jdesc.first_camera()
    juni = JUniforms(
        camera=JCameraUniforms(jnp.asarray(cam.position), jnp.asarray(cam.forward),
                               jnp.asarray(cam.up), jnp.float32(cam.vfov), jnp.float32(0),
                               jnp.float32(0), jnp.float32(0), jnp.float32(cam.clip_start),
                               jnp.float32(cam.clip_end)),
        sample_offset=jnp.int32(offset), inv_total_sample_count=jnp.float32(1.0 / (offset + spp)),
        max_sample_value=jnp.float32(10), rr_inv_min_term_prob=jnp.float32(0.95),
        light_intensity_multiplier=jnp.float32(1), meters_per_scene_unit=jnp.float32(1),
        max_volume_walk_length=jnp.int32(7), dome_rotation=jnp.asarray([0, 0, 0, 1.0]),
        dome_emission_multiplier=jnp.ones(3), dome_diffuse_specular=jnp.ones(2))
    aovs = {}
    for a in ALL_AOVS:
        key = a.name.lower()
        shape = (w * h,) if AOV_CHANNELS[a] == 1 else (w * h, AOV_CHANNELS[a])
        aovs[key] = np.full(shape, -1 if AOV_IS_INT[a] else 0,
                            np.int32 if AOV_IS_INT[a] else np.float32)
    jcfg = JConfig(width=w, height=h, spp=spp, max_bounces=4, nee=True, has_dome=False,
                   aov_mask=mask, tracer="brute")
    ref = jrender_frame(jcfg, juni, jg, jtable, jlight_arrays([rect_light()]), default_dome(),
                        {k: jnp.asarray(v) for k, v in aovs.items()}, jpool, JAccel())
    ref = {k: np.asarray(v) for k, v in ref.items()}

    uni = Uniforms(camera=CameraUniforms(*(torch.as_tensor(np.asarray(x, np.float32))
                                           for x in (cam.position, cam.forward, cam.up)),
                                         float(cam.vfov), 0.0, 0.0, 0.0, float(cam.clip_start),
                                         float(cam.clip_end)),
                   sample_offset=offset,
                   inv_total_sample_count=float(np.float32(1 / (offset + spp))),
                   max_sample_value=10.0, rr_inv_min_term_prob=float(np.float32(0.95)),
                   light_intensity_multiplier=1.0, meters_per_scene_unit=1.0,
                   max_volume_walk_length=7)
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=4, nee=True, aov_mask=mask,
                       tracer="brute")
    got = render_frame(cfg, uni, pack_geometry(tg, "cpu"), ttable.to("cpu"),
                       light_tensors(build_light_arrays([LightDesc(**vars(rect_light()))]), "cpu"),
                       {k: torch.as_tensor(v) for k, v in aovs.items()}, tpool, Accel(soup=tg))
    got = {k: v.numpy() for k, v in got.items()}

    assert set(got) == set(ref)
    for key in ref:
        g, r = got[key], ref[key]
        assert g.shape == r.shape and g.dtype == r.dtype, key
        if key in INT_KEYS or key == "clock_cycles":
            same = (g == r).mean()
            print(f"{key}: {same:.4f} of pixels equal")
            assert same >= 0.99, key
        else:
            frac = _frac_close(g, r, rtol=1e-3, atol=1e-3)
            print(f"{key}: {frac:.4f} of pixels within 1e-3")
            assert frac >= (0.99 if key == "barycentrics" else 0.98), key
    assert (got["object_id"] >= 0).mean() > 0.7
    rel = abs(got["color"].mean() - ref["color"].mean()) / ref["color"].mean()
    assert rel < 0.01 and got["color"][:, :3].mean() > 0.05


# ---------------------------------------------------------------------------
# 5. the committed graphical scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Render.AOVs", "Mesh.PrimvarInterpolation"])
def test_graphical_scene_matches_reference(name):
    scene_path = GRAPHICAL / name / "scene.usda"
    spec = compute_render_spec(load_usd(scene_path))
    settings = {k: v for k, v in spec.settings.items()
                if k not in ("errorPixelThreshold", "flipThreshold")}
    scene, desc, merged = cli.load_gi_scene(str(scene_path), "cpu", settings)
    product = spec.products[0]
    w, h = product.resolution
    bindings, buffers = [], {}
    for var, aov in product.aovs:
        port_aov = AovId(int(aov))
        is_int = AOV_IS_INT[port_aov]
        buf = gi.GiRenderBuffer(w, h, 1 if is_int else max(AOV_CHANNELS[port_aov], 3), is_int)
        bindings.append(gi.GiAovBinding(port_aov, buf, clear_value=-1 if is_int else None))
        buffers[var] = (aov, buf)
    camera = desc.cameras.get(product.camera_path) or desc.first_camera()
    gi.render(gi.GiRenderParams(scene=scene, camera=camera, aov_bindings=bindings,
                                render_settings=merged))
    assert scene._accel is not None and scene._fused is None  # the wavefront route
    threshold = int(spec.settings["errorPixelThreshold"])
    flip_threshold = float(spec.settings["flipThreshold"])
    for var, (aov, buf) in buffers.items():
        img = _encode_srgb_u8(aov, buf.data[::-1])
        ref = jimgio.load_image_file(scene_path.parent / f"ref_{var}.png").data
        errors = int((ref.astype(int) != img.astype(int)).sum())
        flip = mean_flip(ref[..., :3], img[..., :3])
        print(f"{name} {var}: {errors} error components (threshold {threshold}), mean FLIP "
              f"{flip:.4f} (threshold {flip_threshold})")
        assert errors <= threshold and flip <= flip_threshold, var


# ---------------------------------------------------------------------------
# 6. gi routing and the wavefront's gates
# ---------------------------------------------------------------------------

def _bindings(aovs, n=8):
    out = []
    for a in aovs:
        is_int = AOV_IS_INT[a]
        out.append(gi.GiAovBinding(a, gi.GiRenderBuffer(n, n, 1 if is_int else 4, is_int),
                                   clear_value=-1 if is_int else None))
    return out


def _gi_frame(scene, aovs, **settings):
    cam = CameraDesc(position=np.array([0, 0, 3], np.float32),
                     forward=np.array([0, 0, -1], np.float32),
                     up=np.array([0, 1, 0], np.float32), vfov=0.8,
                     clip_start=settings.pop("clip_start", 0.1))
    binds = _bindings(aovs)
    gi.render(gi.GiRenderParams(scene=scene, camera=cam, aov_bindings=binds,
                                render_settings={"spp": 1, "maxBounces": 2, **settings}))
    return [b.render_buffer.data for b in binds]


def _vcolor_grid(scene):
    grid = scene.meshes[0]
    pts = np.zeros((9, 3), np.float32)
    pts[:, :2] = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], indexing="ij"), -1).reshape(9, 2)
    grid.mesh = build_triangulated_mesh(
        pts, np.full(4, 4), np.array([0, 3, 4, 1, 1, 4, 5, 2, 3, 6, 7, 4, 4, 7, 8, 5]),
        colors=np.eye(3, dtype=np.float32)[np.arange(9) % 3])
    grid.material = "/dc"
    node = ShaderNode(path="/dc/s", shader_id="UsdPreviewSurface",
                      inputs={"_vcolor_multiply": True, "diffuseColor": (1.0, 1.0, 1.0)},
                      input_connections={})
    scene.add_material(MaterialDesc(path="/dc", surface_node="/dc/s", nodes={"/dc/s": node}))


def test_gi_routes_between_fused_and_wavefront():
    scene = gi.create_scene("cpu")
    scene.add_mesh(_quad_grid_mesh(4))
    _gi_frame(scene, [AovId.COLOR])
    assert scene._fused is not None and scene._accel is None
    color, obj, cycles = _gi_frame(scene, [AovId.COLOR, AovId.OBJECT_ID, AovId.CLOCK_CYCLES],
                                   nextEventEstimation=True)
    assert scene._accel is not None and scene._tracer == "matrix"
    assert obj.dtype == np.int32 and set(np.unique(obj)) <= {-1, 0} and (obj == 0).any()
    assert np.isfinite(color).all() and (cycles[..., :3] >= 0).all() and (cycles <= 1).all()
    # a near plane beyond the grid leaves every pixel without a first hit
    (obj_clipped,) = _gi_frame(scene, [AovId.OBJECT_ID], clippingPlanes=True, clip_start=5.0)
    assert (obj_clipped == -1).all()

    # vertex colours take the wavefront for AOVs inside the fused mask too,
    # and tint the albedo
    vscene = gi.create_scene("cpu")
    vscene.add_mesh(_quad_grid_mesh(2))
    _vcolor_grid(vscene)
    img, albedo = _gi_frame(vscene, [AovId.COLOR, AovId.ALBEDO], spp=4)
    assert vscene._accel is not None and vscene._fused is None
    rgb = albedo[..., :3].reshape(-1, 3)
    assert np.isfinite(img).all() and rgb.std(axis=0).max() > 0.05


def test_gi_wavefront_gates_raise():
    big = gi.create_scene("cpu")
    big.add_mesh(_quad_grid_mesh(65))  # 8450 triangles
    with pytest.raises(NotImplementedError, match="BVH tracer.*Wavefront integrator"):
        _gi_frame(big, [AovId.OBJECT_ID])
    cut = gi.create_scene("cpu")
    cut.add_mesh(_quad_grid_mesh(2, material="/cut"))
    node = ShaderNode(path="/cut/s", shader_id="UsdPreviewSurface", inputs={"opacity": 0.5},
                      input_connections={})
    cut.add_material(MaterialDesc(path="/cut", surface_node="/cut/s", nodes={"/cut/s": node}))
    # cutout renders on the wavefront (its hit-side draw and the shadow
    # hops); a volume coefficient raises, naming the MDL front end's item
    (faces,) = _gi_frame(cut, [AovId.FACE_ID])
    assert cut._accel is not None and (faces >= -1).all()
    vol = gi.create_scene("cpu")
    vol.add_mesh(_quad_grid_mesh(2))
    _gi_frame(vol, [AovId.FACE_ID])
    vol._lowered_materials[0].params["volume_absorption"] = (0.5, 0.5, 0.5)
    with pytest.raises(NotImplementedError, match="USD content"):
        _gi_frame(vol, [AovId.FACE_ID])


def test_transform_edit_rebuilds_trace_tables():
    scene = gi.create_scene("cpu")
    scene.add_mesh(_quad_grid_mesh(3))
    _gi_frame(scene, [AovId.INSTANCE_ID])
    before = scene._accel.tables.coeffs.clone()
    xf = np.eye(4)
    xf[3, :3] = [0.2, -0.1, 0.3]
    scene.set_mesh_transform(scene.meshes[0], xf)
    _gi_frame(scene, [AovId.INSTANCE_ID])
    fresh = build_trace_tables(build_geometry(scene.meshes, scene._material_index), "cpu")
    assert torch.equal(scene._accel.tables.coeffs, fresh.coeffs)
    assert not torch.equal(scene._accel.tables.coeffs, before)


def test_progressive_wavefront_frames_add_up():
    """Two 1-spp wavefront frames through one scene equal one 2-spp frame
    in the averaged AOVs (the ids and the renormalised normal keep the
    latest sample's value instead)."""
    def frames(spp, n):
        scene, desc, merged = cli.load_gi_scene(CORNELL, "cpu", {"maxBounces": 3, "spp": spp})
        binds = _bindings([AovId.COLOR, AovId.ALBEDO, AovId.FACE_ID])
        params = gi.GiRenderParams(scene=scene, camera=desc.first_camera(), aov_bindings=binds,
                                   render_settings=merged)
        for _ in range(n):
            gi.render(params)
        return [b.render_buffer.data.copy() for b in binds], scene.sample_offset

    two, off2 = frames(1, 2)
    one, off1 = frames(2, 1)
    assert off2 == off1 == 2
    for a, b in zip(two[:2], one[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_cli_writes_an_id_aov(tmp_path):
    out = tmp_path / "faces.png"
    assert cli.main([CORNELL, str(out), "--device", "cpu", "--aov", "face_id",
                     "--image-width", "16", "--image-height", "16", "--spp", "1",
                     "--max-bounces", "2"]) == 0
    png = np.asarray(Image.open(out))
    assert png.shape == (16, 16, 3) and len(np.unique(png)) > 2
    img, _scene = cli.render_scene_file(CORNELL, 16, 16, {"spp": 1, "maxBounces": 2},
                                        AovId.FACE_ID, device="cpu")
    assert img.dtype == np.int32 and img.shape == (16, 16, 1) and img.max() >= 1
