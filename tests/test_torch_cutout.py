"""The port's stochastic cutout against the JAX package's, on the CPU.

A material's untextured opacity (below 1, or against an opacityThreshold)
lets rays through its triangles. The fused kernels draw `cutout_xi`, an
integer hash of the ray's PCG word and the global triangle id, against
each candidate's pass probability inside every search; the wavefront
draws one decision from the path's PCG stream at each hit and walks the
shadow rays' hits one at a time. Held against the JAX package:

1. `cutout_xi` bit-equal to `_cutout_xi` / `_cutout_xi8` on random keys
   and ids, and the kernels' device function (ops/bounce.py
   cutout_draws) on the CPU falls to the same twin;
2. the cutout tables bit-equal to the JAX builders': the resident
   table's two pass-probability columns, the clustered CLU_OPAC /
   CLU_OPAC_SH rows and the instance pass probabilities;
3. one bounce of the twins against the JAX `bounce_step` with `cutout`
   on (state rows 12-15 bit-equal, rows 0-11 within rtol 1e-4 / atol 1e-5
   on 99.9 % of resident rays and 99.5 % of walk rays, as in
   tests/test_torch_lobes.py): the half-open screen of
   tests/test_cutout.py, the binary screen, and the screen that crosses
   only NEE shadow rays, resident and forced into the walk;
4. `render_pixels_fused` against the JAX `render_pixels_fused` on the
   screens: the same samples, means within 1e-3; the pass rate near
   1 - opacity;
5. the wavefront (`render_frame`, brute tracer) against the JAX
   `render_frame` on the screens: COLOR's mean within 1 % and the id
   AOVs equal on 99 % of pixels (the same PCG streams; an edge ray can
   go another way);
6. gi: opacity below 1 sets the static's cutout flag; textured opacity
   raises on the fused route and renders on the wavefront.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gatling_tpu.ops.geometry as jgeom
import gatling_tpu.ops.pallas_bounce as jpb
from gatling_tpu.render.fused import render_pixels_fused as jrender
from gatling_tpu.render.integrator import Accel as JAccel
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.integrator import default_dome
from gatling_tpu.render.integrator import render_frame as jrender_frame
from gatling_tpu.render.lights import build_light_arrays as jlight_arrays

import gatling_tpu_torch.ops.geometry as tgeom
from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId, aov_bit
from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops import bounce_ref as br
from gatling_tpu_torch.render.fused import render_pixels_fused
from gatling_tpu_torch.render.integrator import Accel, RenderConfig, render_frame
from gatling_tpu_torch.render.lights import light_tensors
from gatling_tpu_torch.scene.stage import MaterialDesc, ShaderNode

from test_torch_clustered_bounce import check, primary_state, uniforms
from test_torch_clustered_scene import JAX, TORCH, assert_bits, port_flattened
from test_torch_lobes import port_tables
from test_torch_render import _quad_grid_mesh, _render
from test_torch_split_bounce import _port_uniforms

W = H = 32  # the bounce wave: 1024 rays
MIN_AGREE_RESIDENT, MIN_AGREE_WALK = 0.999, 0.995
# the camera of tests/test_cutout.py's NEE scene: between screen and wall
SHADOW_CAMERA = ((0.37, 0.11, -1.4), (0.02, 0.01, -1.0))
SCREEN_CAMERA = ((0.37, 0.11, 5.0), (0.02, 0.01, -1.0))


def _quad(lib, z: float, size: float = 5.0):
    pts = np.array([[-size, -size, z], [size, -size, z], [-size, size, z], [size, size, z]],
                   np.float32)
    return lib.mesh.build_triangulated_mesh(pts, np.array([4]), np.array([0, 1, 3, 2]))


def screen_scene(lib, opacity: float, threshold: float = 0.0, shadow: bool = False):
    """tests/test_cutout.py's scenes in either package: a black screen of
    `opacity` at z=1 before an emissive wall at z=-3; with `shadow`, the
    screen at z=0 crosses only the shadow rays from a diffuse wall at z=-3
    to a rect light at z=3. Returns (meshes, material index, lowered
    rows, lights)."""
    meshes = [
        lib.stage.MeshDesc(path="/screen", mesh=_quad(lib, 0.0 if shadow else 1.0),
                           transform=np.eye(4), material="screen", double_sided=True,
                           object_id=0),
        lib.stage.MeshDesc(path="/wall", mesh=_quad(lib, -3.0), transform=np.eye(4),
                           material="wall", double_sided=True, object_id=1),
    ]
    midx = {"screen": 0, "wall": 1, None: 2}
    screen = lib.mat.LoweredMaterial(params=dict(lib.mat._DEFAULTS),
                                     traits=lib.mat.MaterialTraits(has_cutout=True), textures={})
    screen.params.update(opacity=opacity, opacity_threshold=threshold,
                         base_color=(0.0, 0.0, 0.0))
    wall = lib.mat.LoweredMaterial(params=dict(lib.mat._DEFAULTS), traits=lib.mat.MaterialTraits(),
                                   textures={})
    if shadow:
        wall.params.update(base_color=(0.8, 0.8, 0.8))
    else:
        wall.params.update(emissive=(1.0, 1.0, 1.0), base_color=(0.0, 0.0, 0.0))
    rows = [screen, wall, lib.mat.lower_material(None)]
    lights = []
    if shadow:
        xf = np.eye(4)
        xf[3, :3] = [0.0, 0.0, 3.0]  # UsdLux rect default forward is -Z
        lights = [lib.stage.LightDesc(
            path="/l", light_type="rect", transform=xf,
            params=dict(intensity=6.0, exposure=0.0, color=np.array([1.0, 1.0, 1.0], np.float32),
                        normalize=False, diffuse=1.0, specular=1.0,
                        enableColorTemperature=False, colorTemperature=6500.0,
                        width=1.0, height=1.0))]
    return meshes, midx, rows, lights


SCREENS = {  # opacity, threshold, shadow screen
    "half_open": (0.3, 0.0, False),
    "binary_open": (0.3, 0.5, False),
    "binary_shut": (0.8, 0.5, False),
    "shadow_half": (0.5, 0.0, True),
}


# ---------------------------------------------------------------------------
# 1. the draws
# ---------------------------------------------------------------------------

def test_cutout_xi_matches_jax():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 32, size=(512, 1), dtype=np.uint64).astype(np.uint32)
    base = np.uint32(rng.integers(0, 1 << 20))
    lanes = np.arange(128, dtype=np.uint32)[None, :]
    ref = np.asarray(jpb._cutout_xi(jnp.asarray(keys), jnp.uint32(base), jnp.asarray(lanes)))
    tid = (int(base) + lanes.astype(np.int64))
    got = br.cutout_xi(torch.tensor(keys.astype(np.int64)), torch.tensor(tid)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # the resident search's form: one id against a [8, 128] block of keys
    key8 = keys[:8 * 64, 0].reshape(8, 64)
    for t in rng.integers(0, 1 << 24, size=4):
        ref8 = np.asarray(jpb._cutout_xi8(jnp.asarray(key8), jnp.uint32(t)))
        got8 = br.cutout_xi(torch.tensor(key8.astype(np.int64)), torch.tensor(int(t))).numpy()
        np.testing.assert_array_equal(got8.view(np.int32), ref8.view(np.int32))
    # uniform in [0, 1): the mean of a million draws within 5 sigma of 1/2
    many = br.cutout_xi(torch.tensor(keys[:, 0].astype(np.int64))[:, None],
                        torch.arange(2048)[None, :])
    assert 0.0 <= float(many.min()) and float(many.max()) < 1.0
    assert abs(float(many.double().mean()) - 0.5) < 5 * (1 / 12 / many.numel()) ** 0.5


def test_cutout_draws_wrapper_on_the_cpu():
    """The kernels' draw function: on CPU tensors the twin, bit for bit;
    the uint32 words travel as int32 bits."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    ids = rng.integers(0, 1 << 31, size=4096, dtype=np.uint64).astype(np.uint32)
    got = tb.cutout_draws(torch.tensor(keys.view(np.int32)), torch.tensor(ids.view(np.int32)))
    ref = br.cutout_xi(torch.tensor(keys.astype(np.int64)), torch.tensor(ids.astype(np.int64)))
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


# ---------------------------------------------------------------------------
# 2. the tables
# ---------------------------------------------------------------------------

def test_cutout_tables_match_jax():
    """Resident (pass-probability columns after the 32 rows), flattened
    clustered (CLU_OPAC / CLU_OPAC_SH) and instanced (inst_smem columns 12
    and 14) tables of cutout scenes, bit for bit; the port pads resident
    rows to 36 floats."""
    jm, jidx, jrows, _ = screen_scene(JAX, 0.3)
    tm, tidx, trows, _ = screen_scene(TORCH, 0.3)
    jt, tt = JAX.mat.build_material_table(jrows), TORCH.mat.build_material_table(trows)
    jg, tg = jgeom.build_geometry(jm, jidx), tgeom.build_geometry(tm, tidx)
    jscene, jstatic = jpb.build_fused_scene(jg, jt, None)
    tscene, tstatic = tb.build_fused_scene(tg, tt, None, "cpu")
    assert jstatic.cutout and tstatic.cutout and tscene.cutout and not tstatic.advanced
    ref = np.asarray(jscene.tris).T  # [T, 34]
    assert tscene.tris.shape == (ref.shape[0], 36)
    assert_bits(tscene.tris[:, :34].numpy(), ref, "resident")
    assert not tscene.tris[:, 34:].any()
    opac = tscene.tris[:, br.tr_opac_col(tscene.tris)].numpy()
    assert sorted(set(opac.tolist())) == [np.float32(0.3), 1.0]

    ref, jstatic, _order = jpb.build_fused_scene_with_order(jg, jt, None, resident_max=0)
    got, _order = port_flattened(tg, tt)
    assert jstatic.cutout
    assert_bits(got.tris, ref.tris, "flattened")

    from test_torch_lobes import lobe_field

    jm, jidx, jt = lobe_field(JAX)
    tm, tidx, tt = lobe_field(TORCH)
    ref, jstatic = jpb.build_fused_scene_instanced(jm, jidx, jt, None, min_gain=1.5, min_flat=0)
    got, counts = tb.instanced_arrays(tm, tidx, tt, min_gain=1.5, min_flat=0)
    assert jstatic.cutout and counts["cutout"] and counts["advanced"]
    for field in ("tris", "inst_smem", "inst_map", "inst_attr"):
        assert_bits(getattr(got, field), getattr(ref, field), field)
    walk = tb.walk_tables(got.l1, got.l2, got.inst_map, got.inst_attr, "cpu", got.inst_smem)
    np.testing.assert_array_equal(walk.inst[:, br.INST_PASS].numpy(),
                                  np.asarray(ref.inst_smem)[:, 12])
    np.testing.assert_array_equal(walk.inst[:, br.INST_PASS_SH].numpy(),
                                  np.asarray(ref.inst_smem)[:, 14])


# ---------------------------------------------------------------------------
# 3. one bounce of the twins
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def bounce_case(name: str, clustered: bool):
    opacity, threshold, shadow = SCREENS[name]
    meshes, midx, rows, lights = screen_scene(JAX, opacity, threshold, shadow)
    scene, static = jpb.build_fused_scene(
        jgeom.build_geometry(meshes, midx), JAX.mat.build_material_table(rows),
        jlight_arrays(lights) if lights else None, resident_max=0 if clustered else 4096)
    # an opacity at or above its threshold is opaque: no cutout branch
    assert static.cutout == (name != "binary_shut") and static.clustered == clustered
    nee = shadow
    uni = uniforms(*(SHADOW_CAMERA if shadow else SCREEN_CAMERA), vfov=0.5)
    cfg = JConfig(width=W, height=H, has_dome=False, nee=nee)
    state = primary_state(uni, seed=9)
    steps = {}
    with pltpu.force_tpu_interpret_mode():
        for b in range(2):
            params = jpb.make_params(cfg, uni, jnp.int32(b))
            out = jax.block_until_ready(jpb.bounce_step(params, scene, state, static=static,
                                                        nee=nee))
            steps[b] = (np.asarray(params), np.asarray(state), np.asarray(out))
            state = out
    return scene, static, steps, nee


@pytest.mark.parametrize("name,clustered", [*((n, False) for n in sorted(SCREENS)),
                                            ("half_open", True), ("shadow_half", True)])
def test_cutout_twin_matches_jax_bounce_step(name, clustered):
    scene, static, steps, nee = bounce_case(name, clustered)
    fs = port_tables(scene, static)
    assert fs.cutout == static.cutout and (fs.walk is not None) == clustered
    for b, (params, state_in, ref) in steps.items():
        st = tb.state_from_numpy(state_in, "cpu")
        tb.bounce_step(torch.tensor(params), fs, st, nee)
        check(ref, tb.state_to_numpy(st), f"{name} clustered={clustered} bounce {b}",
              MIN_AGREE_WALK if clustered else MIN_AGREE_RESIDENT)


def test_camera_pass_rate_of_the_twin_search():
    """On the half-open screen's wave, the resident search without and with
    the draws: the share of screen hits that pass is 1 - opacity within 4
    sigma, and a pass lands on the wall behind."""
    scene, static, steps, _nee = bounce_case("half_open", False)
    fs = port_tables(scene, static)
    st = tb.state_from_numpy(steps[0][1], "cpu")
    o, d = (st[0], st[1], st[2]), (st[3], st[4], st[5])
    _t, _u, _v, win = br.closest_hit(fs.tris, o, d, 0.0)
    _t, _u, _v, win_cut = br.closest_hit(fs.tris, o, d, 0.0, br.cutout_key(st))
    mat = fs.tris[:, br.TR_MAT]
    screen = mat[win.clamp(min=0)] == 0
    passed = screen & (win_cut != win)
    n = int(screen.sum())
    rate = float(passed.sum()) / n
    assert n > 500 and abs(rate - 0.7) < 4 * (0.21 / n) ** 0.5, (n, rate)
    assert (mat[win_cut[passed]] == 1).all()


# ---------------------------------------------------------------------------
# 4. render_pixels_fused against the JAX fused path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,expect", [("half_open", 0.7), ("shadow_half", None)])
def test_render_pixels_fused_cutout_matches_jax(name, expect):
    """16x16, 2 spp: the same samples through both fused paths, means
    within 1e-3 and 98 % of pixels within 1e-3; the half-open screen's
    mean near its pass rate 0.7 (test_cutout.py's 0.08)."""
    w = h = 16
    spp, bounces = 2, 3
    opacity, threshold, shadow = SCREENS[name]
    meshes, midx, rows, lights = screen_scene(JAX, opacity, threshold, shadow)
    scene, static = jpb.build_fused_scene(jgeom.build_geometry(meshes, midx),
                                          JAX.mat.build_material_table(rows),
                                          jlight_arrays(lights) if lights else None)
    juni = uniforms(*(SHADOW_CAMERA if shadow else SCREEN_CAMERA), vfov=0.2)
    jcfg = JConfig(width=w, height=h, spp=spp, max_bounces=bounces, nee=shadow, has_dome=False,
                   jittered=False, fis=False, rr_bounce_offset=100)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrender(jcfg, juni, scene, default_dome(), pix, spp, jnp.int32(0),
                                 static=static))
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=bounces, nee=shadow,
                       jittered=False, fis=False, rr_bounce_offset=100)
    got = render_pixels_fused(cfg, _port_uniforms(juni, 0), port_tables(scene, static),
                              torch.arange(w * h), spp, 0).numpy()
    assert np.isfinite(got).all() and (got >= 0).all() and ref.mean() > 0.01
    rel = abs(got.mean() - ref.mean()) / ref.mean()
    close = (np.abs(got - ref) <= 1e-3 * np.maximum(1.0, np.abs(ref))).all(axis=1)
    print(f"{name}: mean {got.mean():.4f} (JAX {ref.mean():.4f}), {int((~close).sum())} "
          "pixels outside 1e-3")
    assert rel < 1e-3 and close.mean() >= 0.98
    if expect is not None:
        assert abs(got.mean() - expect) < 0.08


# ---------------------------------------------------------------------------
# 5. the wavefront against the JAX render_frame
# ---------------------------------------------------------------------------

IDS = (AovId.OBJECT_ID, AovId.FACE_ID, AovId.INSTANCE_ID)


@pytest.mark.parametrize("name", ["half_open", "shadow_half"])
def test_wavefront_cutout_matches_jax_render_frame(name):
    """16x16, 4 spp, 3 bounces, COLOR and the ids, the brute tracer on both
    sides: the hit-side draw passes a rejected hit through; the shadow
    rays hop through the screen (_trace_occluded_cutout)."""
    w = h = 16
    spp = 4
    opacity, threshold, shadow = SCREENS[name]
    jm, midx, jrows, jl = screen_scene(JAX, opacity, threshold, shadow)
    tm, _midx, trows, tl = screen_scene(TORCH, opacity, threshold, shadow)
    jtable, jpool = JAX.mat.build_materials(jrows)
    ttable, tpool = TORCH.mat.build_materials(trows)
    jg, tg = jgeom.build_geometry(jm, midx), tgeom.build_geometry(tm, midx)
    mask = aov_bit(AovId.COLOR) | sum(aov_bit(a) for a in IDS)
    aovs = {"color": np.zeros((w * h, 4), np.float32)}
    for a in IDS:
        aovs[a.name.lower()] = np.full((w * h,), -1, np.int32)
    juni = uniforms(*(SHADOW_CAMERA if shadow else SCREEN_CAMERA), vfov=0.5)
    kw = dict(width=w, height=h, spp=spp, max_bounces=3, nee=shadow, jittered=False, fis=False,
              rr_bounce_offset=100, has_cutout=True, aov_mask=mask, tracer="brute")
    ref = jrender_frame(JConfig(has_dome=False, **kw), juni, jg, jtable,
                        jlight_arrays(jl), default_dome(),
                        {k: jnp.asarray(v) for k, v in aovs.items()}, jpool, JAccel())
    ref = {k: np.asarray(v) for k, v in ref.items()}
    uni = _port_uniforms(juni, 0)
    got = render_frame(RenderConfig(**kw), uni, tgeom.pack_geometry(tg, "cpu"), ttable.to("cpu"),
                       light_tensors(TORCH.lights.build_light_arrays(tl), "cpu"),
                       {k: torch.as_tensor(v) for k, v in aovs.items()}, tpool, Accel(soup=tg))
    got = {k: v.numpy() for k, v in got.items()}
    for a in IDS:
        key = a.name.lower()
        same = float((got[key] == ref[key]).mean())
        print(f"{name} {key}: {same:.4f} of pixels equal")
        assert same >= 0.99, key
    gc, rc = got["color"][:, :3], ref["color"][:, :3]
    rel = abs(gc.mean() - rc.mean()) / rc.mean()
    print(f"{name}: COLOR mean {gc.mean():.4f} (JAX {rc.mean():.4f})")
    assert np.isfinite(gc).all() and rel < 0.01
    if not shadow:  # the pass rate: the blend sums the spp samples of the wall's 1.0
        assert abs(gc.mean() / spp - 0.7) < 0.08


# ---------------------------------------------------------------------------
# 6. gi
# ---------------------------------------------------------------------------

def _cut_material(path: str, **inputs):
    node = ShaderNode(path=path + "/s", shader_id="UsdPreviewSurface", inputs=inputs,
                      input_connections={})
    return MaterialDesc(path=path, surface_node=node.path, nodes={node.path: node})


def test_gi_opacity_sets_cutout():
    """opacity < 1 (and a threshold that opens the material) sets the
    static's cutout flag on the resident route; an opaque one does not."""
    for inputs, cut in ((dict(opacity=0.5), True), (dict(opacity=0.3, opacityThreshold=0.5), True),
                        (dict(opacity=0.8, opacityThreshold=0.5), False), ({}, False)):
        scene = gi.create_scene("cpu")
        scene.add_mesh(_quad_grid_mesh(2, material="/cut"))
        scene.add_material(_cut_material("/cut", **inputs))
        img = _render(scene)
        assert np.isfinite(img).all() and not scene._fused_static.clustered
        assert scene._fused_static.cutout == cut and scene._fused.cutout == cut, inputs


def test_gi_textured_opacity_raises_on_fused_renders_on_wavefront():
    """A textured opacity raises on the fused route (the re-trace stage,
    ROADMAP item 5b) and renders on the wavefront, whose taps run."""
    def scene_with_texture():
        scene = gi.create_scene("cpu")
        scene.add_mesh(_quad_grid_mesh(2, material="/tex"))
        nodes = {
            "/tex/s": ShaderNode(path="/tex/s", shader_id="UsdPreviewSurface", inputs={},
                                 input_connections={"opacity": ("/tex/img", "r")}),
            "/tex/img": ShaderNode(path="/tex/img", shader_id="UsdUVTexture",
                                   inputs={"file": "mask.png", "fallback": (0.4, 0.4, 0.4, 1.0)},
                                   input_connections={}),
        }
        scene.add_material(MaterialDesc(path="/tex", surface_node="/tex/s", nodes=nodes))
        return scene

    with pytest.raises(NotImplementedError, match="First-hit AOVs, clipping and textured"):
        _render(scene_with_texture())
    scene = scene_with_texture()
    img = _render(scene, AovId.OBJECT_ID)
    assert scene._accel is not None and scene._fused is None and np.isfinite(img).all()
