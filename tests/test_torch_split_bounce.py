"""The port's split bounce against the JAX package's.

Textured scenes trace (K3), sample their textures and shade (K4) on each
bounce. On the CPU the port runs the kernels' plain twins
(ops/split_ref.py), held here against the JAX `trace_step` / `shade_step`
in Pallas interpret mode and against its `_material_rows`:

1. the tangent-row tables (resident [T, 48], flattened and instanced
   [C, 56, 128]) bit-equal to the JAX builders';
2. K3's twin against `trace_step` and K4's twin against `shade_step` on
   a 1024-ray wave: the textured Cornell box in resident tables, a small
   textured interior (3,840 triangles) in flattened and instanced ones;
   with and without tangent rows (a normal map), NEE off and on; at
   bounces 0 and 2. Both shades get the JAX hit and parameter buffers.
   Hit rows H_HIT and H_MAT must agree and the other rows hold rtol 1e-4 /
   atol 1e-5 on the alive rays; state rows 12-15 bit-equal and 0-11
   within the same tolerance; each on 99.5 % of rays (XLA's and PyTorch's
   cos/sin differ in the last bits and can move a ray; the JAX walk picks
   its winners with bf16 hi/lo products, the port in f32).
   Dead rays: the port writes 0s; the JAX resident kernel computes them
   in live blocks, so they are not compared;
3. the texture stage (`material_rows`) against `_material_rows`, within
   1e-6 (x ** 2.4 of sRGB textures; the normal map's norm);
4. `render_pixels_fused` against the JAX fused path on a 16x16 textured
   Cornell box (resident) and an 8x8 textured interior (instanced), with
   and without textureLodBounces, as test_render_pixels_fused_matches_jax;
5. `gi.render` of textured scenes on the CPU, and the gates that raise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

import gatling_tpu.ops.geometry as jgeom
import gatling_tpu.ops.pallas_bounce as jpb
import gatling_tpu.render.material as jmat
import gatling_tpu.render.texture as jtex
from gatling_tpu.render.fused import _material_rows as jmaterial_rows
from gatling_tpu.render.fused import render_pixels_fused as jrender
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.integrator import default_dome
from gatling_tpu.render.lights import build_light_arrays as jlight_arrays
from gatling_tpu.scene import examples as jex
from gatling_tpu.scene.stage import load_scene as jload_scene

import gatling_tpu_torch.ops.geometry as tgeom
from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops import split_ref as sr
from gatling_tpu_torch.render import material as tmat
from gatling_tpu_torch.render import texture as ttex
from gatling_tpu_torch.render.camera import CameraUniforms
from gatling_tpu_torch.render.fused import render_pixels_fused
from gatling_tpu_torch.render.integrator import RenderConfig, Uniforms
from gatling_tpu_torch.scene import examples as tex

from test_torch_bounce import CORNELL, rect_light
from test_torch_clustered_bounce import port_tables, primary_state, uniforms

RTOL, ATOL = 1e-4, 1e-5
MIN_AGREE = 0.995
W = H = 32  # 1024 rays
CAMERA = ((-2.1, -3.0, 1.6), (3.0, 4.8, -0.7))  # the interior's camera


@pytest.fixture(scope="module")
def tex_dir(tmp_path_factory):
    """The interior's textures, a leaning normal map and a checker."""
    d = tmp_path_factory.mktemp("split_tex")
    lean = np.zeros((2, 2, 4), np.uint8)
    lean[...] = (200, 128, 230, 255)
    Image.fromarray(lean, "RGBA").save(d / "lean.png")
    c = (np.arange(64)[:, None] // 8 + np.arange(64)[None, :] // 8) % 2
    checker = np.stack([np.where(c, 230, 90), np.where(c, 200, 120), np.where(c, 90, 220),
                        np.full_like(c, 255)], -1).astype(np.uint8)
    Image.fromarray(checker, "RGBA").save(d / "checker.png")
    return d


def _normal_ref(lib, d):
    return lib.TextureRef(file_path=str(d / "lean.png"), scale=(2.0, 2.0, 2.0, 1.0),
                          bias=(-1.0, -1.0, -1.0, 0.0))


def _jax_interior(d, normal_map: bool, cornell: bool = False):
    """JAX: the scene's description, material index, (raw table, pool),
    means table and lowered rows: the textured interior, or the textured
    Cornell box (the bench's 64x64 checker on every base colour)."""
    desc = jload_scene(CORNELL) if cornell else jex.interior(detail=1, tex_dir=str(d))
    paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    rows = [jmat.lower_material(desc.materials.get(p) if p else None) for p in midx]
    for r in rows:
        if cornell:
            r.textures["base_color"] = jtex.TextureRef(file_path=str(d / "checker.png"))
        if normal_map:
            r.textures["normal"] = _normal_ref(jtex, d)
    table, pool = jmat.build_materials(rows)
    return desc, midx, table, pool, jmat.substitute_texture_means(table, pool), rows


def _port_pool(jp) -> ttex.TexturePool:
    """The JAX pool's arrays as the port's pool."""
    def a(name):
        v = np.asarray(getattr(jp, name))
        return torch.tensor(v.view(np.int32) if v.dtype == np.uint32 else v)

    return ttex.TexturePool(**{f: a(f) for f in ttex.TexturePool._fields})


def _port_table(jt) -> tmat.MaterialTable:
    return tmat.MaterialTable(np.asarray(jt.packed_f), np.asarray(jt.packed_i)).to("cpu")


@functools.lru_cache(maxsize=None)
def jax_case(layout: str, tangents: bool, nee: bool, d):
    """JAX tables of the textured interior and, for bounces 0 and 2 of a
    1024-ray wave, the params, the state going in, the JAX hit buffer,
    parameter buffer (and normal-mapped hit buffer) and shaded state."""
    cornell = layout == "resident"
    desc, midx, table, pool, means, rows = _jax_interior(d, tangents, cornell)
    lights = jlight_arrays([rect_light()] if cornell else desc.lights) if nee else None
    if layout == "instanced":
        scene, static = jpb.build_fused_scene_instanced(desc.meshes, midx, means, lights,
                                                        min_gain=1.5, min_flat=0)
    else:
        scene, static = jpb.build_fused_scene(jgeom.build_geometry(desc.meshes, midx), means,
                                              lights, resident_max=4096 if layout == "resident"
                                              else 0)
    active = jmat.textured_params(rows)
    static = dataclasses.replace(static, textured=True, textured_params=active)
    assert static.tangents == tangents and static.clustered == (layout != "resident")
    cam = desc.first_camera()
    uni = uniforms(cam.position, cam.forward, cam.vfov) if cornell else uniforms(*CAMERA)
    cfg = JConfig(width=W, height=H, has_dome=False, nee=nee)
    state = primary_state(uni, seed=3)
    steps = {}
    # each interpreted kernel finishes before the next dispatch: a dispatch
    # while the interpreter's callbacks run can deadlock
    with pltpu.force_tpu_interpret_mode():
        for b in range(3):
            params = jpb.make_params(cfg, uni, jnp.int32(b))
            hit = jax.block_until_ready(jpb.trace_step(params, scene, state, static=static))
            stage = jmaterial_rows(table, pool, hit, active)
            parbuf, hit_n = stage if tangents else (stage, hit)
            out = jax.block_until_ready(jpb.shade_step(params, scene, state, hit_n, parbuf,
                                                       static=static, nee=nee))
            if b in (0, 2):
                steps[b] = tuple(np.asarray(x) for x in (params, state, hit, parbuf, hit_n, out))
            state = out
    return scene, static, table, pool, active, steps


def shade_twin(p, fs, state, hitbuf, parbuf, active, nee):
    """K4's twin (ops/split_ref.py shade_ref) on the given hit and parameter
    buffers, in place: the shade without the texture stage."""
    sr.shade_ref(p, fs.tris, fs.mats, fs.lights, tuple(fs.light_types.tolist()), state, hitbuf,
                 parbuf, sr.par_row_starts(active), nee, fs.walk, fs.advanced, fs.cutout,
                 fs.volumes)


def _agree(got, ref, mask, min_agree, label, exact_rows=(), close_rows=slice(None)):
    """exact_rows agree bit for bit, close_rows within RTOL/ATOL, each on
    min_agree of the rays in mask."""
    got, ref = got.reshape(got.shape[0], -1)[:, mask], ref.reshape(ref.shape[0], -1)[:, mask]
    n = got.shape[1]
    for row in exact_rows:
        diff = int((got[row].view(np.int32) != ref[row].view(np.int32)).sum())
        assert diff <= n * (1 - min_agree), (label, row, diff)
    close = np.isclose(got[close_rows], ref[close_rows], rtol=RTOL, atol=ATOL).all(axis=0)
    print(f"{label}: {int((~close).sum())} of {n} rays outside tolerance")
    assert close.mean() >= min_agree, (label, int((~close).sum()))


CASES = [(layout, tan, nee) for layout in ("resident", "flattened", "instanced")
         for tan, nee in ((False, False), (True, True))]


@pytest.mark.parametrize("layout,tangents,nee", CASES)
@pytest.mark.parametrize("bounce", [0, 2])
def test_split_twins_match_jax(tex_dir, layout, tangents, nee, bounce):
    scene, static, table, pool, active, steps = jax_case(layout, tangents, nee, tex_dir)
    params, state_in, hit_ref, par_ref, hit_n_ref, out_ref = steps[bounce]
    fs = port_tables(scene, static)
    assert sr.has_tangents(fs.tris) == tangents
    st = tb.state_from_numpy(state_in, "cpu")
    p = torch.tensor(params)
    alive = st[13].numpy() > 0.5
    assert alive.sum() > 300  # the bounce does work

    # K3's twin
    hit = tb.trace_step(p, fs, st)
    assert hit.shape[0] == (24 if tangents else 16)
    _agree(hit.numpy(), hit_ref, alive, MIN_AGREE, f"{layout} trace bounce {bounce}",
           exact_rows=(sr.H_HIT, sr.H_MAT))
    assert int((hit[sr.H_HIT] > 0.5).sum()) > 300

    # the texture stage on the JAX hit buffer
    hb = torch.tensor(hit_ref.reshape(hit_ref.shape[0], -1))
    parbuf, hit_n = sr.material_rows(_port_table(table), _port_pool(pool), hb, active)
    np.testing.assert_allclose(parbuf.numpy(), par_ref.reshape(par_ref.shape[0], -1),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(hit_n.numpy(), hit_n_ref.reshape(hit_n_ref.shape[0], -1),
                               rtol=0, atol=1e-6)

    # K4's twin on the JAX buffers
    shade_twin(p, fs, st, torch.tensor(hit_n_ref.reshape(hit_n_ref.shape[0], -1)),
               torch.tensor(par_ref.reshape(par_ref.shape[0], -1)), active, nee)
    got = tb.state_to_numpy(st)
    _agree(got, out_ref, np.ones_like(alive), MIN_AGREE,
           f"{layout} shade bounce {bounce}", exact_rows=(12, 13, 14, 15),
           close_rows=slice(0, 12))
    if nee:  # shadow rays were traced
        assert got.reshape(16, -1)[15].sum() - state_in.reshape(16, -1)[15].sum() > alive.sum()


def test_tangent_tables_match_jax(tex_dir):
    """Normal-mapped tables carry the tangent rows, bit-equal to JAX's."""
    from test_torch_clustered_scene import assert_bits, port_flattened

    desc, midx, jt, jp, jmeans, _rows = _jax_interior(tex_dir, True)
    tdesc = tex.interior(detail=1, tex_dir=str(tex_dir))
    trows = [tmat.lower_material(tdesc.materials.get(p) if p else None) for p in midx]
    for r in trows:
        r.textures["normal"] = _normal_ref(ttex, tex_dir)
    tt, tp = tmat.build_materials(trows)
    tmeans = tmat.substitute_texture_means(tt, tp)
    np.testing.assert_array_equal(tmeans.packed_f, np.asarray(jmeans.packed_f))
    assert tb.uses_tangents(tmeans)
    jg = jgeom.build_geometry(desc.meshes, midx)
    tg = tgeom.build_geometry(tdesc.meshes, midx)
    n = tb.real_triangles(tg)
    assert_bits(tb.tri_rows(tgeom.SceneGeometry(*[a[:n] for a in tg]), True),
                jpb._tri_rows(jgeom.SceneGeometry(*[a[:n] for a in jg]), True), "resident")
    ref, jstatic, _order = jpb.build_fused_scene_with_order(jg, jmeans, None, resident_max=0)
    got, _order = port_flattened(tg, tmeans)
    assert jstatic.tangents and got.tris.shape[1] == 56
    assert_bits(got.tris, ref.tris, "flattened")
    ref, jstatic = jpb.build_fused_scene_instanced(desc.meshes, midx, jmeans, None,
                                                   min_gain=1.5, min_flat=0)
    got, counts = tb.instanced_arrays(tdesc.meshes, midx, tmeans, min_gain=1.5, min_flat=0)
    assert counts["tangents"] and jstatic.tangents
    for field in ("tris", "inst_map", "inst_attr"):
        assert_bits(getattr(got, field), getattr(ref, field), field)


def _port_uniforms(juni, offset):
    cam = juni.camera
    return Uniforms(
        camera=CameraUniforms(torch.tensor(np.asarray(cam.position)),
                              torch.tensor(np.asarray(cam.forward)),
                              torch.tensor(np.asarray(cam.up)), float(cam.vfov),
                              0.0, 0.0, 0.0, float(cam.clip_start), float(cam.clip_end)),
        sample_offset=offset, inv_total_sample_count=1.0, max_sample_value=10.0,
        rr_inv_min_term_prob=float(np.float32(0.95)), light_intensity_multiplier=1.0,
        meters_per_scene_unit=1.0, max_volume_walk_length=7)


def _textured_cornell(d):
    """The JAX tables of the bench's cornell_textured, with the rect light."""
    desc, midx, table, pool, means, rows = _jax_interior(d, False, cornell=True)
    lights = [l for l in desc.lights if l.light_type != "dome"] + [rect_light()]
    scene, static = jpb.build_fused_scene(jgeom.build_geometry(desc.meshes, midx), means,
                                          jlight_arrays(lights))
    cam = desc.first_camera()
    return scene, static, table, pool, jmat.textured_params(rows), uniforms(
        cam.position, cam.forward, cam.vfov)


@pytest.mark.parametrize("scene_name,lod", [("cornell", 0), ("cornell", 2), ("interior", 0),
                                            ("interior", 1)])
def test_render_pixels_fused_textured_matches_jax(tex_dir, scene_name, lod):
    if scene_name == "cornell":
        w = h = 16
        spp, bounces, offset = 2, 3, 5
        scene, static, table, pool, active, juni = _textured_cornell(tex_dir)
    else:
        w = h = 8
        spp, bounces, offset = 1, 3, 3
        desc, midx, table, pool, means, rows = _jax_interior(tex_dir, False)
        scene, static = jpb.build_fused_scene_instanced(desc.meshes, midx, means,
                                                        jlight_arrays(desc.lights),
                                                        min_gain=1.5, min_flat=0)
        active = jmat.textured_params(rows)
        juni = uniforms(*CAMERA)
    static = dataclasses.replace(static, textured=True, textured_params=active)
    jcfg = JConfig(width=w, height=h, spp=spp, max_bounces=bounces, nee=True, has_dome=False,
                   tex_lod_bounces=lod)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrender(jcfg, juni, scene, default_dome(), pix, spp,
                                 jnp.int32(offset), static=static, materials=table,
                                 textures=pool))
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=bounces, nee=True,
                       tex_lod_bounces=lod)
    got = render_pixels_fused(cfg, _port_uniforms(juni, offset), port_tables(scene, static),
                              torch.arange(w * h), spp, offset, materials=_port_table(table),
                              textures=_port_pool(pool), textured_params=active).numpy()
    assert got.shape == ref.shape == (w * h, 3)
    assert np.isfinite(got).all() and ref.mean() > 0.01
    rel = abs(got.mean() - ref.mean()) / ref.mean()
    close = (np.abs(got - ref) <= 1e-3 * np.maximum(1.0, np.abs(ref))).all(axis=1)
    print(f"{scene_name} lod {lod}: mean rel diff {rel:.2e}, {int((~close).sum())} of {w * h} "
          "pixels outside 1e-3")
    assert rel < 1e-3
    assert close.mean() >= 0.98


def _gi_scene(desc):
    scene = gi.create_scene("cpu")
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    return scene


def _gi_frame(scene, desc, res, **settings):
    buf = gi.GiRenderBuffer(res, res, 4)
    scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                                render_settings=dict(settings)))
    return buf.data.copy()


def test_gi_renders_textured_interior_on_the_cpu(tex_dir):
    """gi.render of the textured interior (3,840 triangles, resident) on
    the CPU: finite, non-negative, lit; the textureLodBounces=1 frame
    (indirect light from the texture means) within 10 % of the all-taps
    frame's mean; the kernels' table holds the means."""
    desc = tex.interior(detail=1, tex_dir=str(tex_dir))
    scene = _gi_scene(desc)
    taps = _gi_frame(scene, desc, 16, spp=2, maxBounces=3, nextEventEstimation=True)
    st = scene._fused_static
    assert st.textured and st.textured_params == ("base_color",) and not st.clustered
    assert np.isfinite(taps).all() and (taps >= 0).all() and taps[..., :3].mean() > 0.05
    lod = _gi_frame(scene, desc, 16, spp=2, maxBounces=3, nextEventEstimation=True,
                    textureLodBounces=1)
    assert abs(lod[..., :3].mean() - taps[..., :3].mean()) < 0.1 * taps[..., :3].mean()
    means = tmat.substitute_texture_means(scene._material_table, scene._texture_pool)
    np.testing.assert_array_equal(scene._fused.mats.numpy(), means.packed_f)
    assert not np.array_equal(means.packed_f, scene._material_table.packed_f)


def test_gi_textured_routes(tex_dir):
    """The instanced route takes textures and normal maps (tangent rows);
    a material edit rebuilds the pool and the tables."""
    desc = tex.interior(detail=2, tex_dir=str(tex_dir))
    scene = _gi_scene(desc)
    img = _gi_frame(scene, desc, 8, spp=1, maxBounces=2, nextEventEstimation=True)
    assert scene._fused_static.instanced and scene._fused_static.textured
    assert not scene._fused_static.tangents and np.isfinite(img).all()
    for m in scene.materials.values():  # a normal map on every material
        m.nodes["/nm"] = type(m.nodes[m.surface_node])(
            path="/nm", shader_id="UsdUVTexture",
            inputs={"file": str(tex_dir / "lean.png"), "sourceColorSpace": "raw"},
            input_connections={})
        m.nodes[m.surface_node].input_connections["normal"] = ("/nm", "rgb")
        scene.add_material(m)
    img2 = _gi_frame(scene, desc, 8, spp=1, maxBounces=2, nextEventEstimation=True)
    assert scene._fused_static.instanced and scene._fused_static.tangents
    assert scene._fused.tris.shape[1] == 56 and np.isfinite(img2).all()
    assert not np.array_equal(img, img2)


@pytest.mark.parametrize("what", ["opacity_texture", "anisotropy", "procedural"])
def test_gi_textured_gates_raise(tex_dir, what):
    """The gates of a textured scene: a procedural input (baked into a pool
    slot of its own), an opacity texture and an anisotropic material render
    on the fused route. (The name dates from when all three raised; it is
    kept so that the cases' records run on.)"""
    desc = tex.interior(detail=1, tex_dir=str(tex_dir))
    m = next(iter(desc.materials.values()))
    surf = m.nodes[m.surface_node]
    if what == "anisotropy":
        # an anisotropic material passes the gate and takes the advanced
        # lobes with tangent rows; with an absorbing medium too, the split
        # bounce's absorption branch (a scattering one would take the
        # wavefront: the split bounce has no free flight)
        scene = _gi_scene(desc)
        _gi_frame(scene, desc, 8, spp=1, maxBounces=2)
        scene._lowered_materials[0].params["anisotropy"] = 0.5
        table = tmat.build_material_table(scene._lowered_materials)
        assert tb.advanced_from_table(table) and tb.uses_tangents(table)
        assert not tb.has_volumes(table)
        from gatling_tpu_torch.scene.examples import uber_material

        scene.add_material(uber_material(m.path, anisotropy=0.5, transmission=1.0,
                                         roughness=0.3, volume_absorption=(0.5, 0.5, 0.5)))
        img = _gi_frame(scene, desc, 8, spp=1, maxBounces=3, mediumStackSize=1)
        st = scene._fused_static
        assert np.isfinite(img).all() and st.textured and st.tangents and st.advanced
        assert st.volumes and not st.scatter and scene._fused.volumes == tb.VOL_ABSORB
        return
    if what == "opacity_texture":
        # the first material's alpha as its opacity: the fused route
        # re-traces what it rejects, and textureLodBounces gives way
        surf.input_connections["opacity"] = (m.path + "/tex", "a")
        scene = _gi_scene(desc)
        img = _gi_frame(scene, desc, 8, spp=1, maxBounces=2, nextEventEstimation=True,
                        textureLodBounces=1)
        st = scene._fused_static
        assert np.isfinite(img).all() and (img >= 0).all() and img[..., :3].mean() > 0
        assert st.textured and st.cutout_textured and "opacity" in st.textured_params
        assert scene._fused is not None and scene._accel is None
        return
    m.nodes["/noise"] = type(surf)(path="/noise", shader_id="ND_noise2d_color3", inputs={},
                                   input_connections={})
    surf.input_connections["roughness"] = ("/noise", "out")
    scene = _gi_scene(desc)
    img = _gi_frame(scene, desc, 8, spp=1, maxBounces=2)
    st = scene._fused_static
    # perlin noise about 0 reaches below 0: an HDR composite, the float pool
    assert np.isfinite(img).all() and st.textured and "roughness" in st.textured_params
    assert not scene._texture_pool.packed and scene._fused is not None
