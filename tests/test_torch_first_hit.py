"""The fused route's bounce-0 peel against the JAX package's, on the CPU.

First-hit AOVs (NORMAL, ALBEDO, DEPTH, TEXCOORDS) and camera clipping
planes peel bounce 0 off the fused sample loop (render/fused.py): K3
traces, the far plane filters the hits, K4's taps alone (ops/bounce.py
tap_rows) give the material at the hit, K4 shades. Held here, with the
kernels' plain twins on the port's side and the JAX fused path in Pallas
interpret mode on the other, the same samples:

1. `render_pixels_fused(..., want_first_hit=True)` on tests/data/cornell.usda
   at 16x16, 2 spp, 2 bounces, unjittered (tests/test_fused.py:590's setup):
   hit masks equal on 99.9 % of pixels, the AOVs within rtol 1e-4 /
   atol 1e-5 where both hit, COLOR as tests/test_torch_cutout.py holds a
   fused frame (means within 1e-3, 98 % of pixels within 1e-3);
2. the same on the textured, normal-mapped Cornell box (ALBEDO and NORMAL
   from the taps);
3. clipping planes at the three ranges of tests/test_fused.py:850 (open,
   a near plane that cuts the room, a far plane that cuts it), each frame
   against the JAX fused frame, and the near and far cuts changing the
   image as that test asserts;
4. tests/test_analytic_parity.py's geometric AOVs through gi.render on the
   fused route (DEPTH and TEXCOORDS: an id AOV would take the wavefront),
   against the same independent pinhole projection;
5. the peel of a scene in the scatter mode (mediumStackSize 1), which
   shades bounce 0 in the absorption mode as the JAX shade_step does.
"""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gatling_tpu.ops.geometry as jgeom
import gatling_tpu.ops.pallas_bounce as jpb
from gatling_tpu.render import material as jmat
from gatling_tpu.render.fused import render_pixels_fused as jrender
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.integrator import default_dome
from gatling_tpu.render.lights import build_light_arrays as jlight_arrays
from gatling_tpu.render.texture import empty_pool as jempty_pool
from gatling_tpu.scene.stage import load_scene as jload_scene

from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId, aov_bit
from gatling_tpu_torch.render.fused import render_pixels_fused
from gatling_tpu_torch.render.integrator import RenderConfig
from gatling_tpu_torch.scene.meshproc import Interpolation, build_triangulated_mesh
from gatling_tpu_torch.scene.stage import CameraDesc, MeshDesc

from test_torch_bounce import CORNELL
from test_torch_clustered_bounce import uniforms
from test_torch_lobes import port_tables
from test_torch_split_bounce import _jax_interior, _port_pool, _port_table, _port_uniforms
from test_torch_split_bounce import tex_dir  # noqa: F401 (fixture)

W = 16
FIRST_HIT_MASK = (aov_bit(AovId.COLOR) | aov_bit(AovId.NORMAL) | aov_bit(AovId.ALBEDO)
                  | aov_bit(AovId.DEPTH) | aov_bit(AovId.TEXCOORDS))
AOV_RTOL, AOV_ATOL = 1e-4, 1e-5
MIN_HIT_AGREE = 0.999


@functools.lru_cache(maxsize=None)
def cornell_case():
    """JAX tables of tests/data/cornell.usda: (scene, static, raw table, uniforms)."""
    desc = jload_scene(CORNELL)
    paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    rows = [jmat.lower_material(desc.materials.get(p) if p else None) for p in midx]
    table = jmat.build_material_table(rows)
    scene, static = jpb.build_fused_scene(jgeom.build_geometry(desc.meshes, midx), table, None)
    cam = desc.first_camera()
    juni = uniforms(cam.position, cam.forward, cam.vfov)
    juni = juni._replace(camera=juni.camera._replace(clip_start=jnp.float32(cam.clip_start),
                                                     clip_end=jnp.float32(cam.clip_end)))
    return scene, static, table, juni


def _both_first_hit(scene, static, table, pool, juni, active, nee=False, port_scene=None,
                    res=W, bounces=2):
    """The JAX and the port's first-hit frames of the same samples (res x
    res, 2 spp): ((color, fh) JAX, (color, fh) port), fh as NumPy dicts;
    the port's tables `port_scene`, by default port_tables of the JAX
    ones."""
    jcfg = JConfig(width=res, height=res, spp=2, max_bounces=bounces, jittered=False,
                   fis=False, has_dome=False, rr_bounce_offset=100, aov_mask=FIRST_HIT_MASK,
                   nee=nee)
    pix = jnp.arange(res * res, dtype=jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        color, _segs, fh = jrender(jcfg, juni, scene, default_dome(), pix, 2, jnp.int32(0),
                                   static=static, materials=table, textures=pool,
                                   want_first_hit=True, with_stats=True)
    ref = (np.asarray(color), {k: np.asarray(v) for k, v in fh.items()})
    cfg = RenderConfig(width=res, height=res, spp=2, max_bounces=bounces, jittered=False,
                       fis=False, rr_bounce_offset=100, aov_mask=FIRST_HIT_MASK, nee=nee)
    tcolor, _segs, tfh = render_pixels_fused(
        cfg, _port_uniforms(juni, 0), port_scene or port_tables(scene, static),
        torch.arange(res * res), 2, 0,
        materials=_port_table(table), textures=_port_pool(pool), textured_params=active,
        want_first_hit=True, split=static.textured)
    return ref, (tcolor.numpy(), {k: v.numpy() for k, v in tfh.items()})


def _check_first_hit(ref, got, label):
    (rcolor, rfh), (gcolor, gfh) = ref, got
    assert np.isfinite(gcolor).all() and rcolor.mean() > 0.01
    rel = abs(gcolor.mean() - rcolor.mean()) / rcolor.mean()
    close = (np.abs(gcolor - rcolor) <= 1e-3 * np.maximum(1.0, np.abs(rcolor))).all(axis=1)
    agree = (gfh["hit"] == rfh["hit"]).mean()
    print(f"{label}: hits agree on {agree:.4f}, COLOR mean rel {rel:.2e}, "
          f"{int((~close).sum())} pixels outside 1e-3")
    assert agree >= MIN_HIT_AGREE and gfh["hit"].mean() > 0.5
    both = gfh["hit"] & rfh["hit"]
    for key in ("normal", "albedo", "depth", "texcoords"):
        np.testing.assert_allclose(gfh[key][both], rfh[key][both], rtol=AOV_RTOL,
                                   atol=AOV_ATOL, err_msg=f"{label} {key}")
    assert rel < 1e-3 and close.mean() >= 0.98


def test_first_hit_aovs_match_jax_cornell():
    scene, static, table, juni = cornell_case()
    ref, got = _both_first_hit(scene, static, table, jempty_pool(), juni, ())
    _check_first_hit(ref, got, "cornell")
    # unit normals; the albedo is the diffuse albedo plus the Schlick
    # Fresnel term (bsdf.auxiliary), which reaches 1 where the view grazes
    # the surface: at most 2 without a clearcoat (the JAX frame's reaches
    # 1.725 on this box)
    hit = got[1]["hit"]
    np.testing.assert_allclose(np.linalg.norm(got[1]["normal"][hit], axis=1), 1.0, atol=1e-5)
    assert (got[1]["albedo"] >= 0).all() and (got[1]["albedo"] <= 2).all()


def test_first_hit_aovs_match_jax_textured_normal_mapped(tex_dir):  # noqa: F811
    """The textured Cornell box with a normal map on every material: ALBEDO
    from the tapped base colour, NORMAL from the normal-mapped taps."""
    desc, midx, table, pool, means, rows = _jax_interior(tex_dir, True, cornell=True)
    scene, static = jpb.build_fused_scene(jgeom.build_geometry(desc.meshes, midx), means,
                                          jlight_arrays([]))
    active = jmat.textured_params(rows)
    static = dataclasses.replace(static, textured=True, textured_params=active)
    assert static.tangents and "base_color" in active
    _s, _st, _t, juni = cornell_case()
    ref, got = _both_first_hit(scene, static, table, pool, juni, active)
    _check_first_hit(ref, got, "cornell textured, normal-mapped")


@pytest.mark.parametrize("clip", [(0.1, 100.0), (6.5, 100.0), (0.1, 7.0)],
                         ids=["open", "near", "far"])
def test_clipping_planes_match_jax(clip):
    """12x12, 8 spp, 3 bounces (tests/test_fused.py:850), COLOR only: the
    clip-only peel keeps the spp batching."""
    frames = clipping_frames()
    got, ref = frames[clip]
    assert np.isfinite(got).all() and (got >= 0).all()
    rel = abs(got.mean() - ref.mean()) / max(ref.mean(), 1e-6)
    close = (np.abs(got - ref) <= 1e-3 * np.maximum(1.0, np.abs(ref))).all(axis=1)
    print(f"clip {clip}: mean {got.mean():.5f} (JAX {ref.mean():.5f}), "
          f"{int((~close).sum())} pixels outside 1e-3")
    assert rel < 1e-3 and close.mean() >= 0.98
    if clip != (0.1, 100.0):
        m_open = frames[(0.1, 100.0)][0].mean()
        if clip[0] > 1.0:
            assert abs(got.mean() - m_open) > 0.005  # the near plane cuts the front
        else:
            assert got.mean() < 0.6 * m_open  # the far plane cuts the back


@functools.lru_cache(maxsize=None)
def clipping_frames():
    scene, static, table, juni = cornell_case()
    w = h = 12
    spp = 8
    pix = jnp.arange(w * h, dtype=jnp.int32)
    fs = port_tables(scene, static)
    out = {}
    for cs, ce in [(0.1, 100.0), (6.5, 100.0), (0.1, 7.0)]:
        u2 = juni._replace(camera=juni.camera._replace(clip_start=jnp.float32(cs),
                                                       clip_end=jnp.float32(ce)))
        jcfg = JConfig(width=w, height=h, spp=spp, max_bounces=3, has_dome=False,
                       clipping_planes=True)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jrender(jcfg, u2, scene, default_dome(), pix, spp, jnp.int32(0),
                                     static=static, materials=table, textures=jempty_pool()))
        cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=3, clipping_planes=True)
        got = render_pixels_fused(cfg, _port_uniforms(u2, 0), fs, torch.arange(w * h), spp, 0,
                                  materials=_port_table(table), textures=_port_pool(jempty_pool()),
                                  split=False).numpy()
        out[(cs, ce)] = (got, ref)
    return out


def test_geometric_aovs_against_projection_math():
    """tests/test_analytic_parity.py:189 on the port's fused route: the
    DEPTH and TEXCOORDS AOVs of a screen-filling quad through gi.render
    against an independent numpy pinhole projection."""
    z_wall = -5.0
    pts = np.array([[-20, -20, z_wall], [20, -20, z_wall],
                    [-20, 20, z_wall], [20, 20, z_wall]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    mesh = build_triangulated_mesh(pts, np.array([4]), np.array([0, 1, 3, 2]),
                                   uvs=uv, uvs_interp=Interpolation.VERTEX)
    scene = gi.create_scene("cpu")
    scene.add_mesh(MeshDesc(path="/w", mesh=mesh, transform=np.eye(4), material=None,
                            double_sided=True, object_id=7))
    w = h = 16
    vfov = 0.6
    # clip_start 0: the DEPTH AOV is the raw hit distance
    cam = CameraDesc(position=np.zeros(3, np.float32), forward=np.array([0, 0, -1], np.float32),
                     up=np.array([0, 1, 0], np.float32), vfov=vfov, clip_start=0.0,
                     clip_end=1000.0)
    bufs = {a: gi.GiRenderBuffer(w, h, 3) for a in (AovId.DEPTH, AovId.TEXCOORDS)}
    gi.render(gi.GiRenderParams(
        scene=scene, camera=cam,
        aov_bindings=[gi.GiAovBinding(a, b) for a, b in bufs.items()],
        render_settings=dict(spp=1, maxBounces=1, jitteredSampling=False,
                             filterImportanceSampling=False, rrBounceOffset=100)))
    assert scene._fused is not None and scene._accel is None  # the fused route
    depth = bufs[AovId.DEPTH].data[..., 0]
    texc = bufs[AovId.TEXCOORDS].data
    tan_half = math.tan(vfov / 2)
    for (py, px) in [(3, 4), (8, 8), (12, 2), (1, 14)]:
        ndc_x = (2.0 * (px + 0.5) / w - 1.0) * tan_half * (w / h)
        ndc_y = (2.0 * (py + 0.5) / h - 1.0) * tan_half
        ray = np.array([ndc_x, ndc_y, -1.0])
        p = ray * (z_wall / ray[2])
        exp_depth = np.linalg.norm(p)
        assert abs(depth[py, px] - exp_depth) < 2e-3 * exp_depth, (py, px)
        assert abs(texc[py, px, 0] - (p[0] + 20.0) / 40.0) < 2e-3, (py, px)
        assert abs(texc[py, px, 1] - (p[1] + 20.0) / 40.0) < 2e-3, (py, px)


def test_first_hit_peel_at_medium_stack_1_matches_jax(tmp_path):
    """The peel of a scene in the scatter mode (mediumStackSize 1, the fog
    box of tests/test_torch_volumes.py): the JAX shade_step has no scatter
    branch, so bounce 0 shades in the absorption mode (a ray entering a
    medium there carries the alive row 2.0), and the port's peel does the
    same; K1's scatter mode from bounce 1. 12x12, 2 spp, 3 bounces, NEE."""
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.scene import examples as ex

    from test_torch_volumes import fog_box_jax

    geom, table, lights = fog_box_jax(ex.cornell_fog(str(tmp_path)))
    scene, static = jpb.build_fused_scene(geom, table, lights)
    static = dataclasses.replace(static, volumes=True, scatter=True)
    _s, _st, _t, juni = cornell_case()
    fs = port_tables(scene, static)._replace(volumes=tb.VOL_SCATTER)
    ref, got = _both_first_hit(scene, static, table, jempty_pool(), juni, (), nee=True,
                               port_scene=fs, res=12, bounces=3)
    _check_first_hit(ref, got, "fog box, mediumStackSize 1")
