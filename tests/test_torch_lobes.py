"""The port's advanced lobe set against the JAX package's, on the CPU.

The advanced lobes are clearcoat, anisotropic GGX and thick refraction
with the exact dielectric Fresnel and total internal reflection. On the
CPU the port runs the kernels' plain twins. They are held against the JAX
kernels in Pallas interpret mode:

1. `lower_material` of the MaterialX surfaces (open_pbr_surface,
   standard_surface, gltf_pbr) against JAX's: parameters, texture
   requests and material-table rows equal;
2. one bounce of the resident twin (K1's) against the JAX `bounce_step`
   with `advanced` on: the thick-glass, TIR, clearcoat and thin-walled
   slabs of tests/test_advanced_bsdf_fused.py, an anisotropic slab and
   the clearcoat slab under a rect light with NEE, at bounces 0 and 1;
3. the walk twin (K2's) on an instanced field whose placements are
   clearcoated, thick glass and cutout, in instance tables and forced
   into flattened clustered tables (`resident_max` 0);
4. K3's and K4's twins against `trace_step` / `shade_step` on a small
   untextured anisotropic scene with UVs (tangent rows, the empty texture
   pool), resident and instanced;
5. `render_pixels_fused` against the JAX `render_pixels_fused` on the
   TIR and clearcoat slabs;
6. gi's routing of the lobes.

Tolerances: state rows 12-15 bit-equal and rows 0-11 within rtol 1e-4 /
atol 1e-5, each on 99.9 % of the rays of a resident wave (XLA's and
PyTorch's sqrt, cos/sin and pow differ in the last bits, and JAX takes
rsqrt where the port divides by sqrt; a ray on a Fresnel or lobe
threshold can flip) and on 99.5 % of a walk's (the JAX walk picks its
winners with bf16 hi/lo products, about 2^-16 relative, the port in f32).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gatling_tpu.ops.geometry as jgeom
import gatling_tpu.ops.pallas_bounce as jpb
import gatling_tpu.render.material as jmat
import gatling_tpu.render.texture as jtex
from gatling_tpu.render.fused import _material_rows as jmaterial_rows
from gatling_tpu.render.fused import render_pixels_fused as jrender
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.integrator import default_dome
from gatling_tpu.render.lights import build_light_arrays as jlight_arrays
from gatling_tpu.scene.stage import load_scene as jload_scene

import gatling_tpu_torch.render.material as tmat
from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops import split_ref as sr
from gatling_tpu_torch.render.fused import render_pixels_fused
from gatling_tpu_torch.render.integrator import RenderConfig
from gatling_tpu_torch.scene.stage import load_scene as tload_scene

from test_advanced_bsdf_fused import _mat, _scene
from test_torch_bounce import CORNELL, rect_light
from test_torch_clustered_bounce import check, primary_state, uniforms
from test_torch_clustered_scene import JAX, TORCH
from test_torch_split_bounce import _agree, _port_uniforms

GLASS_COATED = "tests/graphical/Materials.GlassCoated/scene.usda"
MIN_AGREE_RESIDENT, MIN_AGREE_WALK = 0.999, 0.995
W = H = 32  # the wave: 1024 rays
SLAB_CAMERA = ((0.37, 0.11, 5.0), (0.1, 0.05, -1.0))  # looks down -z onto the slab


def port_tables(scene, static, device="cpu"):
    """The port's tables carrying the JAX arrays, flags and instance pass
    probabilities."""
    kw = {}
    if static.clustered:
        kw = dict(l1=np.asarray(scene.l1_aabbs), l2=np.asarray(scene.l2_aabbs))
    if static.instanced:
        kw.update(inst_map=np.asarray(scene.inst_map), inst_attr=np.asarray(scene.inst_attr),
                  inst_smem=np.asarray(scene.inst_smem))
    return tb.from_jax_tables(np.asarray(scene.tris), np.asarray(scene.mats),
                              np.asarray(scene.lights), static.light_types, device,
                              advanced=static.advanced, cutout=static.cutout, **kw)


def slab_light(lib):
    """A 1x1 rect light at z = 3 over the slab, emitting down (-z)."""
    xf = np.eye(4)
    xf[3, :3] = [0.3, 0.2, 3.0]
    return lib.stage.LightDesc(
        path="/l", light_type="rect", transform=xf,
        params=dict(intensity=6.0, exposure=0.0, color=np.array([1.0, 0.95, 0.9], np.float32),
                    normalize=False, diffuse=1.0, specular=1.0, enableColorTemperature=False,
                    colorTemperature=6500.0, width=1.0, height=1.0))


# ---------------------------------------------------------------------------
# 1. the MaterialX surfaces
# ---------------------------------------------------------------------------

def _surface(lib, sid: str, inputs: dict, tex_input: str | None = None):
    """A material desc whose surface node is `sid` with `inputs`; with
    `tex_input`, that input connected to a UsdUVTexture."""
    nodes = {}
    conns = {}
    if tex_input:
        nodes["/m/tex"] = lib.stage.ShaderNode(
            path="/m/tex", shader_id="UsdUVTexture",
            inputs={"file": "marble.png", "sourceColorSpace": "raw"}, input_connections={})
        conns[tex_input] = ("/m/tex", "rgb")
    nodes["/m/s"] = lib.stage.ShaderNode(path="/m/s", shader_id=sid, inputs=dict(inputs),
                                         input_connections=conns)
    return lib.stage.MaterialDesc(path="/m", surface_node="/m/s", nodes=nodes)


SURFACES = {
    "open_pbr": ("ND_open_pbr_surface_surfaceshader", dict(
        base_color=(0.9, 0.8, 0.7), base_metalness=0.3, specular_roughness=0.35,
        specular_ior=1.45, transmission_weight=0.6, coat_weight=0.8, coat_roughness=0.15,
        specular_roughness_anisotropy=0.6, geometry_opacity=0.7, emission_luminance=2.5,
        emission_color=(1.0, 0.5, 0.25), geometry_thin_walled=True), "base_color"),
    "standard_surface": ("ND_standard_surface_surfaceshader", dict(
        base_color=(0.2, 0.4, 0.6), metalness=0.9, specular_roughness=0.25, coat=0.5,
        coat_roughness=0.05, specular_anisotropy=0.4, specular_rotation=0.125, specular_IOR=1.6,
        transmission=0.2, opacity=(0.8, 0.8, 0.8), emission=1.5, emission_color=(0.3, 0.6, 0.9),
        thin_walled=True), "specular_roughness"),
    "standard_surface_short_id": ("standard_surface", dict(base_color=(0.5, 0.5, 0.5)), None),
    "gltf_pbr": ("ND_gltf_pbr_surfaceshader", dict(
        base_color=(0.7, 0.2, 0.1), metallic=0.5, roughness=0.45, transmission=0.3, alpha=0.4,
        emissive=(0.1, 0.2, 0.3), alpha_mode="MASK", alpha_cutoff=0.35), "base_color"),
    "gltf_pbr_blend": ("gltf_pbr", dict(alpha=0.6, alpha_mode="BLEND"), None),
}


def _same_lowering(jrow, trow, label):
    for k, v in trow.params.items():
        ref = jrow.params[k]
        assert np.allclose(np.asarray(v, np.float64), np.asarray(ref, np.float64), rtol=0,
                           atol=0), (label, k, v, ref)
    assert set(trow.textures) == set(jrow.textures), label
    for k, t in trow.textures.items():
        for f in dataclasses.fields(t):  # the port's fields (JAX's add baked graphs)
            assert getattr(t, f.name) == getattr(jrow.textures[k], f.name), (label, k, f.name)
    assert trow.traits.has_cutout == jrow.traits.has_cutout, label


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_lower_material_surfaces_match_jax(name):
    sid, inputs, tex_input = SURFACES[name]
    for tex in (None, tex_input) if tex_input else (None,):
        jrow = jmat.lower_material(_surface(JAX, sid, inputs, tex))
        trow = tmat.lower_material(_surface(TORCH, sid, inputs, tex))
        _same_lowering(jrow, trow, f"{name} texture={tex}")
    jt = jmat.build_material_table([jrow])
    tt = tmat.build_material_table([trow])
    np.testing.assert_array_equal(tt.packed_f.view(np.int32),
                                  np.asarray(jt.packed_f).view(np.int32))


def test_lower_material_glass_coated_matches_jax():
    """Materials.GlassCoated: an open_pbr thick glass, a clearcoated metal,
    a ground and an emissive backdrop; its table selects the lobes."""
    jdesc, tdesc = jload_scene(GLASS_COATED), tload_scene(GLASS_COATED)
    assert sorted(jdesc.materials) == sorted(tdesc.materials)
    jrows, trows = [], []
    for path in sorted(jdesc.materials):
        jrows.append(jmat.lower_material(jdesc.materials[path]))
        trows.append(tmat.lower_material(tdesc.materials[path]))
        _same_lowering(jrows[-1], trows[-1], path)
    tt = tmat.build_material_table(trows)
    np.testing.assert_array_equal(
        tt.packed_f.view(np.int32), np.asarray(jmat.build_material_table(jrows).packed_f)
        .view(np.int32))
    assert tb.advanced_from_table(tt) and not tb.aniso_from_table(tt)
    assert jpb._advanced_from_table(tt) and not tb.has_volumes(tt)


def test_unknown_surface_raises():
    with pytest.raises(NotImplementedError, match="USD content"):
        tmat.lower_material(_surface(TORCH, "ND_surface_unlit", {}))


# ---------------------------------------------------------------------------
# 2. the resident bounce (K1's twin)
# ---------------------------------------------------------------------------

# Near-specular lobes are left out of the twin parity: at alpha^2 ~ 1e-6 the
# GGX half-vector sample takes sqrt(1 - c2h) of a c2h within 1e-6 of 1, which
# turns a last-bit difference (XLA's CPU code contracts multiply-adds, the
# twin and the kernels do not) into 1e-4 of the direction. The rough lobes
# below cover the same code.
SLABS = {  # material of the slab
    "thick_glass": dict(transmission=1.0, ior=1.5, roughness=0.25),
    "tir": dict(transmission=1.0, ior=2.4, roughness=0.25),
    "thin_walled": dict(transmission=1.0, thin_walled=1, ior=1.5, clearcoat=0.3,
                        clearcoat_roughness=0.35),
}
# the Cornell box under the bench's rect light: clearcoated walls, an
# anisotropic metal tall block and a thick-glass short block
CORNELL_LOBES = {
    "/Cornell/Materials/White": dict(clearcoat=1.0, clearcoat_roughness=0.3),
    "/tall": dict(base_color=(0.9, 0.6, 0.2), metallic=1.0, roughness=0.35, anisotropy=0.7,
                  anisotropy_rotation=0.15),
    "/short": dict(transmission=1.0, ior=1.5, roughness=0.3),
}


def lobe_cornell():
    """JAX tables of the Cornell box with CORNELL_LOBES' materials (the
    blocks rebound to their own) and the bench's rect light."""
    desc = jload_scene(CORNELL)
    for m in desc.meshes:
        if m.path.endswith("/TallBlock"):
            m.material = "/tall"
        elif m.path.endswith("/ShortBlock"):
            m.material = "/short"
    paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    rows = []
    for p in midx:
        row = jmat.lower_material(desc.materials.get(p) if p else None)
        if p in CORNELL_LOBES:
            row.params.update(CORNELL_LOBES[p])
        rows.append(row)
    lights = [l for l in desc.lights if l.light_type != "dome"] + [rect_light()]
    return (jgeom.build_geometry(desc.meshes, midx), jmat.build_material_table(rows),
            jlight_arrays(lights), desc.first_camera())


def _steps(scene, static, uni, nee, bounces=(0, 1), seed=5):
    """For each of `bounces`: the params, the state going in (a camera
    wave stepped by the JAX kernel) and the JAX kernel's output."""
    cfg = JConfig(width=W, height=H, has_dome=False, nee=nee)
    state = primary_state(uni, seed=seed)
    steps = {}
    # each interpreted kernel finishes before the next dispatch: a dispatch
    # while the interpreter's callbacks run can deadlock
    with pltpu.force_tpu_interpret_mode():
        for b in range(max(bounces) + 1):
            params = jpb.make_params(cfg, uni, jnp.int32(b))
            out = jax.block_until_ready(jpb.bounce_step(params, scene, state, static=static,
                                                        nee=nee))
            if b in bounces:
                steps[b] = (np.asarray(params), np.asarray(state), np.asarray(out))
            state = out
    return steps


@functools.lru_cache(maxsize=None)
def resident_case(name: str):
    """JAX tables and stepped waves of a slab (no lights) or of the lobe
    Cornell box (NEE)."""
    if name == "cornell_lobes":
        geom, table, lights, cam = lobe_cornell()
        uni, nee = uniforms(cam.position, cam.forward, cam.vfov), True
    else:
        geom, table = _scene(_mat(**SLABS[name]))
        lights, uni, nee = None, uniforms(*SLAB_CAMERA), False
    scene, static = jpb.build_fused_scene(geom, table, lights)
    assert static.advanced and not static.clustered and not static.cutout
    return scene, static, _steps(scene, static, uni, nee), nee


def _twin_step(scene, static, step, nee, min_agree, label):
    params, state_in, ref = step
    fs = port_tables(scene, static)
    assert fs.advanced == static.advanced and fs.cutout == static.cutout
    st = tb.state_from_numpy(state_in, "cpu")
    tb.bounce_step(torch.tensor(params), fs, st, nee)
    got = tb.state_to_numpy(st)
    check(ref, got, label, min_agree)
    s_in = state_in.reshape(16, -1)
    assert (s_in[13] > 0.5).sum() > 100  # the bounce did work
    return got


@pytest.mark.parametrize("name", [*sorted(SLABS), "cornell_lobes"])
@pytest.mark.parametrize("bounce", [0, 1])
def test_advanced_twin_matches_jax_bounce_step(name, bounce):
    scene, static, steps, nee = resident_case(name)
    got = _twin_step(scene, static, steps[bounce], nee, MIN_AGREE_RESIDENT,
                     f"{name} bounce {bounce}")
    if nee and bounce == 0:  # shadow rays were traced
        s_in = steps[0][1].reshape(16, -1)
        assert got.reshape(16, -1)[15].sum() - s_in[15].sum() > (s_in[13] > 0.5).sum() + 100


# ---------------------------------------------------------------------------
# 3. the walk (K2's twin), instanced and flattened
# ---------------------------------------------------------------------------

def _open_pbr(lib, path: str, **inputs):
    node = lib.stage.ShaderNode(path=path + "/s", shader_id="ND_open_pbr_surface_surfaceshader",
                                inputs=inputs, input_connections={})
    return lib.stage.MaterialDesc(path=path, surface_node=node.path, nodes={node.path: node})


def lobe_field(lib):
    """Four placements of one sphere under two materials over a ground
    (tests/test_torch_clustered_scene.py instanced_field, rotated and
    uniformly scaled): a clearcoated red at opacity 0.6, a rough thick
    glass, and a ground at opacity 0.85. Returns (meshes, material index,
    table)."""
    from test_torch_clustered_scene import instanced_field

    meshes, _mats = instanced_field(lib, stretch=(1.0, 1.0, 1.0))
    descs = {
        "/m0": lib.ex._preview_material("/m0", diffuseColor=(0.8, 0.2, 0.2), roughness=0.4,
                                        clearcoat=1.0, clearcoatRoughness=0.1, opacity=0.6),
        "/m1": _open_pbr(lib, "/m1", transmission_weight=1.0, specular_ior=1.5,
                         specular_roughness=0.2),
        "/mg": lib.ex._preview_material("/mg", diffuseColor=(0.7, 0.7, 0.7), roughness=0.9,
                                        opacity=0.85),
    }
    midx = {p: i for i, p in enumerate(sorted(descs))}
    midx[None] = len(descs)
    rows = [lib.mat.lower_material(descs.get(p) if p else None) for p in midx]
    return meshes, midx, lib.mat.build_material_table(rows)


WALKS = {"instanced_nee": (True, True), "flattened": (False, False)}


@functools.lru_cache(maxsize=None)
def walk_case(label: str):
    instanced, nee = WALKS[label]
    meshes, midx, table = lobe_field(JAX)
    lights = jlight_arrays([slab_light(JAX)]) if nee else None
    if instanced:
        scene, static = jpb.build_fused_scene_instanced(meshes, midx, table, lights,
                                                        min_gain=1.5, min_flat=0)
    else:
        scene, static = jpb.build_fused_scene(jgeom.build_geometry(meshes, midx), table, lights,
                                              resident_max=0)
    assert static.clustered and static.instanced == instanced
    assert static.advanced and static.cutout
    uni = uniforms((-1.5, -4.0, 4.0), (0.2, 0.4, -0.6))
    return scene, static, _steps(scene, static, uni, nee), nee


@pytest.mark.parametrize("label", sorted(WALKS))
@pytest.mark.parametrize("bounce", [0, 1])
def test_advanced_cutout_walk_twin_matches_jax(label, bounce):
    scene, static, steps, nee = walk_case(label)
    _twin_step(scene, static, steps[bounce], nee, MIN_AGREE_WALK, f"{label} bounce {bounce}")


# ---------------------------------------------------------------------------
# 4. the split bounce (K3's and K4's twins) on an anisotropic scene
# ---------------------------------------------------------------------------

def aniso_scene(lib):
    """A closed UV-mapped room (a double-sided box, standard_surface: an
    anisotropic, rotated, clearcoated metal) around two placements of a UV
    sphere (open_pbr: anisotropic metal at opacity 0.7) and a rect light,
    no textures: the split bounce with tangent rows and the empty pool.
    Returns (meshes, index, table, lights)."""
    room = lib.ex._box_mesh((6.0, 6.0, 4.0), uv_scale=2.0, subdiv=1)
    sphere = lib.ex._sphere_uv_mesh(6, 6)  # few triangles: the interpreted resident loop
    xfs = []
    for i, (x, y, s) in enumerate(((-0.8, 0.3, 0.7), (0.9, -0.4, 0.5))):
        xf = np.diag([s, s, s, 1.0])
        th = 0.6 + i
        xf[:2, :2] = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]]) * s
        xf[3, :3] = [x, y, s - 1.95]
        xfs.append(xf)
    meshes = [
        lib.stage.MeshDesc(path="/room", mesh=room, transform=np.eye(4), material="/g",
                           double_sided=True, object_id=0),
        lib.stage.MeshDesc(path="/balls", mesh=sphere, transform=np.eye(4), material="/b",
                           double_sided=False, object_id=1, instance_transforms=np.stack(xfs)),
    ]
    g = lib.stage.ShaderNode(path="/g/s", shader_id="ND_standard_surface_surfaceshader",
                             inputs=dict(base_color=(0.6, 0.5, 0.4), metalness=1.0,
                                         specular_roughness=0.3, specular_anisotropy=0.6,
                                         specular_rotation=0.2, coat=0.5, coat_roughness=0.3),
                             input_connections={})
    descs = {"/g": lib.stage.MaterialDesc(path="/g", surface_node=g.path, nodes={g.path: g}),
             "/b": _open_pbr(lib, "/b", base_color=(0.8, 0.8, 0.9), base_metalness=1.0,
                             specular_roughness=0.25, specular_roughness_anisotropy=0.8,
                             geometry_opacity=0.7)}
    midx = {"/b": 0, "/g": 1, None: 2}
    rows = [lib.mat.lower_material(descs.get(p) if p else None) for p in midx]
    light = slab_light(lib)
    light.transform[3, 2] = 1.8  # under the room's ceiling
    return meshes, midx, lib.mat.build_material_table(rows), [light]


ROOM_CAMERA = ((0.2, -2.6, 0.6), (0.0, 1.0, -0.45))


@functools.lru_cache(maxsize=None)
def split_case(layout: str, nee: bool):
    meshes, midx, table, room_lights = aniso_scene(JAX)
    lights = jlight_arrays(room_lights) if nee else None
    if layout == "instanced":
        scene, static = jpb.build_fused_scene_instanced(meshes, midx, table, lights,
                                                        min_gain=1.5, min_flat=0)
    else:
        scene, static = jpb.build_fused_scene(jgeom.build_geometry(meshes, midx), table, lights)
    assert static.tangents and static.advanced and static.cutout
    assert static.instanced == (layout == "instanced")
    static = dataclasses.replace(static, textured=True, textured_params=())
    pool = jtex.empty_pool()
    uni = uniforms(*ROOM_CAMERA)
    cfg = JConfig(width=W, height=H, has_dome=False, nee=nee)
    state = primary_state(uni, seed=7)
    steps = {}
    with pltpu.force_tpu_interpret_mode():
        for b in range(2):
            params = jpb.make_params(cfg, uni, jnp.int32(b))
            hit = jax.block_until_ready(jpb.trace_step(params, scene, state, static=static))
            parbuf, hit_n = jmaterial_rows(table, pool, hit, ())
            out = jax.block_until_ready(jpb.shade_step(params, scene, state, hit_n, parbuf,
                                                       static=static, nee=nee))
            if b in (0, 1):
                steps[b] = tuple(np.asarray(x) for x in (params, state, hit, parbuf, hit_n, out))
            state = out
    return scene, static, steps


@pytest.mark.parametrize("layout,nee", [("resident", True), ("instanced", True)])
@pytest.mark.parametrize("bounce", [0, 1])
def test_aniso_split_twins_match_jax(layout, nee, bounce):
    scene, static, steps = split_case(layout, nee)
    params, state_in, hit_ref, par_ref, hit_n_ref, out_ref = steps[bounce]
    fs = port_tables(scene, static)
    assert sr.has_tangents(fs.tris) and fs.advanced and fs.cutout
    st = tb.state_from_numpy(state_in, "cpu")
    p = torch.tensor(params)
    alive = st[13].numpy() > 0.5
    assert alive.sum() > 300
    min_agree = MIN_AGREE_RESIDENT if layout == "resident" else MIN_AGREE_WALK

    hit = tb.trace_step(p, fs, st)  # K3's twin, with the cutout draws
    assert hit.shape[0] == sr.HIT_ROWS_TAN
    _agree(hit.numpy(), hit_ref, alive, min_agree, f"{layout} trace bounce {bounce}",
           exact_rows=(sr.H_HIT, sr.H_MAT))
    # K4's twin on the JAX buffers: the mesh-tangent frame of H_TAN / H_BS
    tb.shade_step(p, fs, st, torch.tensor(hit_n_ref.reshape(hit_n_ref.shape[0], -1)),
                  torch.tensor(par_ref.reshape(par_ref.shape[0], -1)), (), nee)
    _agree(tb.state_to_numpy(st), out_ref, np.ones_like(alive), min_agree,
           f"{layout} shade bounce {bounce}", exact_rows=(12, 13, 14, 15),
           close_rows=slice(0, 12))


def test_tangent_frame_changes_the_anisotropic_shade():
    """The mesh-tangent frame is what orients anisotropy: K4's twin on the
    same wave with the tangent rows dropped (the Duff frame) shades
    differently, while an isotropic material is frame-free."""
    scene, static, steps = split_case("resident", True)
    params, state_in, _hit, par_ref, hit_n_ref, out_ref = steps[0]
    fs = port_tables(scene, static)
    hit_n = torch.tensor(hit_n_ref.reshape(hit_n_ref.shape[0], -1))
    par = torch.tensor(par_ref.reshape(par_ref.shape[0], -1))
    with_tan = tb.state_from_numpy(state_in, "cpu")
    tb.shade_step(torch.tensor(params), fs, with_tan, hit_n, par, (), True)
    duff = tb.state_from_numpy(state_in, "cpu")
    tb.shade_step(torch.tensor(params), fs, duff, hit_n[:sr.HIT_ROWS], par, (), True)
    moved = (~torch.isclose(with_tan[3:6], duff[3:6], rtol=1e-4, atol=1e-5)).any(0)
    assert int(moved.sum()) > 50


# ---------------------------------------------------------------------------
# 5. render_pixels_fused against the JAX fused path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tir", "cornell_lobes"])
def test_render_pixels_fused_advanced_matches_jax(name):
    """The same samples through both fused paths (16x16, 2 spp, 4
    bounces): means within 1 % and 98 % of pixels within 1e-3 (a path
    that flips on a last-bit difference ends elsewhere, and one bright
    path moves a 512-sample mean by 0.3 %). The TIR slab
    gains no energy: its mean stays below the emissive wall's radiance 2,
    and no pixel passes the sample clamp (10)."""
    w = h = 16
    spp, bounces = 2, 4
    if name == "cornell_lobes":
        geom, table, lights, cam = lobe_cornell()
        juni, nee = uniforms(cam.position, cam.forward, cam.vfov), True
    else:
        geom, table = _scene(_mat(**SLABS[name]))
        lights, juni, nee = None, uniforms(*SLAB_CAMERA), False
    scene, static = jpb.build_fused_scene(geom, table, lights)
    jcfg = JConfig(width=w, height=h, spp=spp, max_bounces=bounces, nee=nee, has_dome=False)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrender(jcfg, juni, scene, default_dome(), pix, spp, jnp.int32(0),
                                 static=static))
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=bounces, nee=nee)
    got = render_pixels_fused(cfg, _port_uniforms(juni, 0), port_tables(scene, static),
                              torch.arange(w * h), spp, 0).numpy()
    assert np.isfinite(got).all() and (got >= 0).all() and ref.mean() > 0.01
    rel = abs(got.mean() - ref.mean()) / ref.mean()
    close = (np.abs(got - ref) <= 1e-3 * np.maximum(1.0, np.abs(ref))).all(axis=1)
    print(f"{name}: mean rel diff {rel:.2e}, {int((~close).sum())} of {w * h} pixels outside")
    assert rel < 1e-2 and close.mean() >= 0.98
    if name == "tir":
        assert got.mean() < 2.0 and got.max() <= 10.0 + 1e-4


# ---------------------------------------------------------------------------
# 6. gi routing
# ---------------------------------------------------------------------------

def _gi_render(desc, res=8, **settings):
    scene = gi.create_scene("cpu")
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    buf = gi.GiRenderBuffer(res, res, 4)
    gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                                render_settings=dict(spp=1, maxBounces=3, **settings)))
    return scene, buf.data


def test_gi_routes_glass_to_resident_advanced_k1():
    desc = tload_scene(GLASS_COATED)
    scene, img = _gi_render(desc, nextEventEstimation=True)
    st = scene._fused_static
    assert st.advanced and not st.clustered and not st.textured and not st.cutout
    assert scene._fused.advanced and np.isfinite(img).all() and (img >= 0).all()


def test_gi_routes_anisotropy_to_split():
    """An untextured anisotropic scene takes the split bounce (tangent
    rows in the hit buffer, the empty pool) in instance tables."""
    meshes, _midx, _table, lights = aniso_scene(TORCH)
    desc = TORCH.stage.SceneDesc(meshes=meshes, materials={}, lights=lights, cameras={})
    g = TORCH.stage.ShaderNode(path="/g/s", shader_id="ND_standard_surface_surfaceshader",
                               inputs=dict(specular_anisotropy=0.6), input_connections={})
    desc.materials = {"/g": TORCH.stage.MaterialDesc(path="/g", surface_node=g.path,
                                                     nodes={g.path: g}),
                      "/b": _open_pbr(TORCH, "/b", specular_roughness_anisotropy=0.8)}
    fwd = np.array(ROOM_CAMERA[1]) / np.linalg.norm(ROOM_CAMERA[1])
    desc.cameras = {"/c": TORCH.stage.CameraDesc(
        position=np.array(ROOM_CAMERA[0], np.float32), forward=fwd.astype(np.float32),
        up=np.array([0.0, -fwd[2], fwd[1]], np.float32), vfov=0.9)}
    scene, img = _gi_render(desc, nextEventEstimation=True)
    st = scene._fused_static
    assert st.textured and st.textured_params == () and st.tangents and st.advanced
    assert not st.cutout and np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0
    assert sr.has_tangents(scene._fused.tris) and scene._fused.advanced


def test_glass_coated_fused_mean_matches_jax_wavefront():
    """Materials.GlassCoated at 96², 4 spp, its 6 bounces and NEE: the port's
    fused twin (K1's advanced branch) against the JAX package's gi on the
    CPU (its wavefront, the route of the committed reference). The scene's
    own 48 spp takes minutes on the CPU, so the card holds the golden
    (chip_smoke.py phase 4f) and here the means agree within 3 % (the two
    routes draw their samples in other frames, a Duff ONB in the fused
    kernels and the mesh tangent in the wavefront: 4 spp over 9,216 pixels
    leave about 1 % of noise in a mean)."""
    from gatling_tpu import gi as jgi
    from gatling_tpu.interface import AovId as JAovId
    from gatling_tpu.utils.config import default_settings as jdefaults
    from gatling_tpu_torch.utils.config import default_settings

    res, spp = 96, 4
    means = {}
    for name, lib_gi, load, defaults, aov in (
            ("jax", jgi, jload_scene, jdefaults, JAovId.COLOR),
            ("port", gi, tload_scene, default_settings, AovId.COLOR)):
        desc = load(GLASS_COATED)
        scene = lib_gi.create_scene("cpu") if lib_gi is gi else lib_gi.create_scene()
        for m in desc.meshes:
            scene.add_mesh(m)
        for m in desc.materials.values():
            scene.add_material(m)
        for light in desc.lights:
            scene.add_light(light)
        settings = defaults()
        settings.update(desc.render_settings)
        settings.update(spp=spp)
        buf = lib_gi.GiRenderBuffer(res, res, 4)
        lib_gi.render(lib_gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                            aov_bindings=[lib_gi.GiAovBinding(aov, buf)],
                                            render_settings=settings))
        img = np.asarray(buf.data)[..., :3]
        assert np.isfinite(img).all() and (img >= 0).all()
        means[name] = float(img.mean())
        if lib_gi is gi:
            assert scene._fused_static.advanced and scene._fused is not None
    print(f"GlassCoated 96² 4 spp means: port fused {means['port']:.5f}, JAX wavefront "
          f"{means['jax']:.5f}")
    assert abs(means["port"] / means["jax"] - 1.0) < 0.03


def test_golden_errors_match_jax_harness():
    """The port's own copy of the graphical harness's comparison
    (utils/flip.py encode_srgb_u8 and golden_errors, which chip_smoke.py
    holds Materials.GlassCoated to) against the JAX package's
    testing._encode_srgb_u8, error count and flip.mean_flip on a noisy
    render of a random image: the byte images equal, the counts equal, and
    the mean FLIP within 1e-12 (both are the same float64 NumPy sequence)."""
    from gatling_tpu.flip import mean_flip as jmean_flip
    from gatling_tpu.interface import AovId as JAovId
    from gatling_tpu.testing import _encode_srgb_u8 as jencode

    from gatling_tpu_torch.utils.flip import encode_srgb_u8, golden_errors

    rng = np.random.default_rng(11)
    ref_color = rng.uniform(0.0, 1.2, (24, 32, 4)).astype(np.float32)
    color = np.clip(ref_color + rng.normal(0.0, 0.02, ref_color.shape), 0.0, None).astype(
        np.float32)
    ref = jencode(JAovId.COLOR, ref_color[::-1])
    img = encode_srgb_u8(color)
    np.testing.assert_array_equal(img, jencode(JAovId.COLOR, color[::-1]))
    errors, score = golden_errors(color, ref)
    assert errors == int((np.abs(ref.astype(int) - img.astype(int)) > 0).sum()) > 0
    assert abs(score - jmean_flip(ref[..., :3], img[..., :3])) < 1e-12
