"""The port's float texel pool against the JAX package's.

One EXR or Radiance HDR texture makes a scene's whole pool float: every
slot's linear texels in `texels` ([N, 4] f32), the 8-bit slots decoded to
linear on the host (gatling_tpu/render/texture.py:303-380). Held here:

1. `build_pool` over mixed PNG (sRGB and raw), EXR and HDR slots: every
   TexturePool array bit-equal to the JAX package's; an all-PNG pool stays
   8-bit;
2. `sample_pool`'s float branch against JAX's under every wrap mode, black
   included, bit for bit (no x ** 2.4 on this branch);
3. the texture stage (ops/split_ref.py material_rows, K4's twin's first
   half), the taps alone (ops/bounce.py tap_rows_ref, the twin of
   tap_kernel) and the re-trace's opacity tap (render/material.py
   apply_textures, as ops/bounce.py retrace_round_ref takes it) against
   the JAX `_material_rows` and `apply_textures` on a float pool with a
   normal map: the parameter rows and the opacity bit for bit, the
   normal-mapped normal within 1e-6 (XLA's and PyTorch's cross products
   round differently);
4. `tap_mask` sets TAP_FLOAT for a float pool (K4's FLT instances);
5. K4's twin (`shade_step` on a CPU state) from the JAX hit buffer against
   the JAX `_material_rows` + `shade_step` in Pallas interpret mode, on the
   small interior (3,840 triangles, flattened tables) whose floor texture
   is an EXR reaching 4, normal-mapped, NEE on, bounces 0 and 2 of a
   1024-ray wave: rows 12-15 bit-equal and rows 0-11 within rtol 1e-4 /
   atol 1e-5 on 99.5 % of rays, as test_torch_split_bounce.py holds it.
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
from gatling_tpu import imgio as jimgio
from gatling_tpu.render.fused import _material_rows as jmaterial_rows
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.lights import build_light_arrays as jlight_arrays
from gatling_tpu.scene import examples as jex

from gatling_tpu_torch import imgio
from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops import split_ref as sr
from gatling_tpu_torch.render import material as tmat
from gatling_tpu_torch.render import texture as ttex
from gatling_tpu_torch.scene import examples as tex_ex

from test_torch_clustered_bounce import port_tables, primary_state, uniforms
from test_torch_split_bounce import (CAMERA, MIN_AGREE, W, _agree, _normal_ref, _port_pool,
                                     _port_table, tex_dir)  # noqa: F401 (tex_dir: the fixture)

WRAPS = ("black", "clamp", "repeat", "mirror")


def _hdr_texture(seed: int, h: int, w: int, peak: float = 4.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, peak, (h, w, 4)).astype(np.float32)
    img[..., 3] = rng.uniform(0.0, 1.0, (h, w))
    return img


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An sRGB-worthy PNG, a raw PNG, an EXR (half) and a Radiance HDR."""
    d = tmp_path_factory.mktemp("float_pool")
    rng = np.random.default_rng(5)
    out = {"png_a": str(d / "a.png"), "png_b": str(d / "b.png"), "exr": str(d / "c.exr"),
           "hdr": str(d / "d.hdr")}
    imgio.write_image_file(out["png_a"], rng.integers(0, 256, (7, 5, 4)).astype(np.uint8))
    imgio.write_image_file(out["png_b"], rng.integers(0, 256, (4, 9, 4)).astype(np.uint8))
    imgio.write_image_file(out["exr"], _hdr_texture(6, 11, 6))
    imgio.write_image_file(out["hdr"], _hdr_texture(7, 3, 8, peak=40.0))
    return out


def _refs(lib, files, wraps=("repeat", "repeat")):
    ws, wt = wraps
    return [lib.TextureRef(file_path=files["png_a"], is_srgb=True, wrap_s=ws, wrap_t=wt),
            lib.TextureRef(file_path=files["exr"], wrap_s=wt, wrap_t=ws,
                           scale=(0.9, 1.1, 1.0, 0.5), bias=(0.05, 0.0, -0.1, 0.2)),
            lib.TextureRef(file_path=files["png_b"], wrap_s=ws, wrap_t=ws),
            lib.TextureRef(file_path=files["hdr"], is_srgb=True, wrap_s=wt, wrap_t=wt)]


def _assert_pools_equal(jp, tp):
    for name in ttex.TexturePool._fields:
        ref = np.asarray(getattr(jp, name))
        got = getattr(tp, name).numpy()
        if ref.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("wraps", [("repeat", "repeat"), ("clamp", "black")])
def test_build_pool_matches_jax(files, wraps):
    jp = jtex.TextureManager().build_pool(_refs(jtex, files, wraps))
    tp = ttex.TextureManager().build_pool(_refs(ttex, files, wraps))
    _assert_pools_equal(jp, tp)
    assert not tp.packed and not tp.bilinear_packed and tp.has_texels
    assert tp.texels.shape == (7 * 5 + 11 * 6 + 4 * 9 + 3 * 8, 4)
    assert (tp.is_srgb == 0).all() and float(tp.texels.max()) > 4.0
    # the sRGB PNG slot is linear in the pool, the HDR slot as decoded
    png = jimgio.load_image_file(files["png_a"]).as_float_rgba()
    np.testing.assert_array_equal(tp.texels[:35, 3].numpy(), png.reshape(-1, 4)[:, 3])
    assert (tp.texels[:35, :3].numpy() <= png.reshape(-1, 4)[:, :3]).all()
    hdr = imgio.load_image_file(files["hdr"]).reshape(-1, 4)
    np.testing.assert_array_equal(tp.texels[-24:].numpy(), hdr)
    # without the HDR slots the pool stays 8-bit
    jp8 = jtex.TextureManager().build_pool(_refs(jtex, files, wraps)[::2])
    tp8 = ttex.TextureManager().build_pool(_refs(ttex, files, wraps)[::2])
    _assert_pools_equal(jp8, tp8)
    assert tp8.packed and tp8.texels.shape == (1, 4)


@pytest.mark.parametrize("ws,wt", [(a, b) for a in WRAPS for b in WRAPS if a <= b])
def test_sample_pool_float_branch_matches_jax(files, ws, wt):
    """Random uv over [-2.3, 3.1] on every slot (and negative slot ids,
    which read slot 0) of a float pool under the wrap pair."""
    jp = jtex.TextureManager().build_pool(_refs(jtex, files, (ws, wt)))
    tp = ttex.TextureManager().build_pool(_refs(ttex, files, (ws, wt)))
    rng = np.random.default_rng(len(ws) * 7 + len(wt))
    r = 4096
    uv = rng.uniform(-2.3, 3.1, (r, 2)).astype(np.float32)
    slot = rng.integers(-1, 4, r).astype(np.int32)
    ref = np.asarray(jtex.sample_pool(jp, jnp.asarray(slot), jnp.asarray(uv)))
    got = ttex.sample_pool(tp, torch.as_tensor(slot), torch.as_tensor(uv)).numpy()
    np.testing.assert_array_equal(got, ref)
    if "black" in (ws, wt):
        assert (got == 0.0).all(axis=1).any()  # taps outside [0, 1] went black


def _float_rows(ex, mat, tex, d, exr: str):
    """The small interior's lowered materials, normal-mapped, with the
    floor's base colour the EXR and the worktop's roughness the EXR's
    green channel and its opacity the alpha."""
    desc = ex.interior(detail=1, tex_dir=str(d))
    paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    rows = [mat.lower_material(desc.materials.get(p) if p else None) for p in midx]
    for path, r in zip(midx, rows):
        r.textures["normal"] = _normal_ref(tex, d)
        if path == "/m_floor":
            r.textures["base_color"] = dataclasses.replace(r.textures["base_color"],
                                                           file_path=exr, is_srgb=False)
        if path == "/m_worktop":
            r.textures["roughness"] = tex.TextureRef(file_path=exr, channel="g",
                                                     wrap_s="mirror", wrap_t="black")
            r.textures["opacity"] = tex.TextureRef(file_path=exr, channel="a", wrap_s="clamp")
    return desc, midx, rows


@pytest.fixture(scope="module")
def floor_exr(tex_dir):  # noqa: F811
    path = str(tex_dir / "floor.exr")
    imgio.write_image_file(path, _hdr_texture(8, 64, 64))
    return path


def test_texture_stage_and_taps_match_jax_on_a_float_pool(tex_dir, floor_exr):  # noqa: F811
    _, _, jrows = _float_rows(jex, jmat, jtex, tex_dir, floor_exr)
    _, _, trows = _float_rows(tex_ex, tmat, ttex, tex_dir, floor_exr)
    jt, jp = jmat.build_materials(jrows)
    tt, tp = tmat.build_materials(trows)
    _assert_pools_equal(jp, tp)
    assert not tp.packed and tp.count >= 7
    rng = np.random.default_rng(9)
    r, n_mats = 2048, tt.packed_f.shape[0]
    hit = np.zeros((sr.HIT_ROWS_TAN, r), np.float32)
    hit[sr.H_HIT] = rng.random(r) < 0.9
    hit[sr.H_MAT] = rng.integers(0, n_mats, r)
    hit[sr.H_UVX:sr.H_UVY + 1] = rng.uniform(-1.5, 2.5, (2, r))
    n = rng.normal(size=(r, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t = np.cross(n, rng.normal(size=(r, 3))).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    hit[sr.H_N:sr.H_N + 3] = n.T
    hit[sr.H_TAN:sr.H_TAN + 3] = t.T
    hit[sr.H_BS] = np.where(rng.random(r) < 0.5, -1.0, 1.0)
    active = jmat.textured_params(jrows)
    assert set(active) >= {"base_color", "roughness", "opacity"}
    active4 = tuple(a for a in active if a != "opacity")
    par_ref, hit_n_ref, p_ref = jmaterial_rows(jt, jp, jnp.asarray(hit.reshape(-1, r // 128, 128)),
                                               active4, return_params=True)
    par, hit_n = sr.material_rows(_port_table(jt), _port_pool(jp), torch.tensor(hit), active4)
    np.testing.assert_array_equal(par.numpy(), np.asarray(par_ref).reshape(par.shape))
    np.testing.assert_allclose(hit_n.numpy(), np.asarray(hit_n_ref).reshape(hit_n.shape),
                               rtol=0, atol=1e-6)
    tt = tt.to("cpu")
    taps = tb.tap_rows_ref(torch.tensor(hit), tt, tp, active)
    on = hit[sr.H_HIT] > 0.5
    ref_rows = np.concatenate([np.asarray(p_ref.base_color).T, np.asarray(p_ref.metallic)[None]])
    np.testing.assert_array_equal(taps[:tb.TAP_N_ROW].numpy()[:, on], ref_rows[:, on])
    np.testing.assert_allclose(taps[tb.TAP_N_ROW:].numpy()[:, on],
                               hit_n.numpy()[sr.H_N:sr.H_N + 3, on], rtol=0, atol=0)
    jmat_ids = jnp.asarray(hit[sr.H_MAT].astype(np.int32))
    uv = hit[sr.H_UVX:sr.H_UVY + 1].T.copy()
    op = jmat.apply_textures(jt, jp, jmat.gather_params(jt, jmat_ids), jmat_ids,
                             jnp.asarray(uv), ("opacity",))
    ids = torch.tensor(hit[sr.H_MAT].astype(np.int64))
    opacity = tmat.apply_textures(tt, tp, tmat.gather_params(tt, ids), ids, torch.tensor(uv),
                                  ("opacity",)).opacity.numpy()
    np.testing.assert_array_equal(opacity[on], np.asarray(op.opacity)[on])
    assert (opacity[on] < 1.0).any()  # the worktop's tapped alpha


def test_tap_mask_sets_the_float_flag(files):
    tp = ttex.TextureManager().build_pool(_refs(ttex, files))
    tp8 = ttex.TextureManager().build_pool(_refs(ttex, files)[::2])
    base = tb.TAP_BITS["base_color"] | tb.TAP_BITS["roughness"]
    assert tb.tap_mask(base, sr.HIT_ROWS_TAN, tp) == base | tb.TAP_NORMAL | tb.TAP_FLOAT
    assert tb.tap_mask(base, sr.HIT_ROWS, tp) == base | tb.TAP_FLOAT
    assert tb.tap_mask(base, sr.HIT_ROWS_TAN, tp8) == base | tb.TAP_NORMAL
    assert tb.tap_mask(base, sr.HIT_ROWS, ttex.empty_pool()) == 0
    assert tb._walk_entry("gatling_shade_walk", True, tb.VOL_ABSORB, True) == \
        "gatling_shade_walk_vol_nee_flt"


@functools.lru_cache(maxsize=None)
def _jax_float_case(d, exr):
    desc, midx, rows = _float_rows(jex, jmat, jtex, d, exr)
    for r in rows:  # the kernels' table: no opacity texture (its re-trace is another path)
        r.textures.pop("opacity", None)
    table, pool = jmat.build_materials(rows)
    means = jmat.substitute_texture_means(table, pool)
    scene, static = jpb.build_fused_scene(jgeom.build_geometry(desc.meshes, midx), means,
                                          jlight_arrays(desc.lights), resident_max=0)
    active = jmat.textured_params(rows)
    static = dataclasses.replace(static, textured=True, textured_params=active)
    assert static.tangents and static.clustered
    uni = uniforms(*CAMERA)
    cfg = JConfig(width=W, height=W, has_dome=False, nee=True)
    state = primary_state(uni, seed=4)
    steps = {}
    with pltpu.force_tpu_interpret_mode():
        for b in range(3):
            params = jpb.make_params(cfg, uni, jnp.int32(b))
            hit = jax.block_until_ready(jpb.trace_step(params, scene, state, static=static))
            parbuf, hit_n = jmaterial_rows(table, pool, hit, active)
            out = jax.block_until_ready(jpb.shade_step(params, scene, state, hit_n, parbuf,
                                                       static=static, nee=True))
            if b in (0, 2):
                steps[b] = tuple(np.asarray(x) for x in (params, state, hit, out))
            state = out
    return scene, static, table, pool, active, steps


@pytest.mark.parametrize("bounce", [0, 2])
def test_shade_step_on_a_float_pool_matches_jax(tex_dir, floor_exr, bounce):  # noqa: F811
    scene, static, table, pool, active, steps = _jax_float_case(tex_dir, floor_exr)
    params, state_in, hit_ref, out_ref = steps[bounce]
    assert not bool(np.asarray(pool.texels_u32).shape[0] > 1)  # the pool is float
    fs = port_tables(scene, static)
    st = tb.state_from_numpy(state_in, "cpu")
    alive = st[13].numpy() > 0.5
    assert alive.sum() > 300
    tpool = _port_pool(pool)
    assert tb.tap_mask(1, hit_ref.shape[0], tpool) & tb.TAP_FLOAT
    calls = sr.stage_calls
    tb.shade_step(torch.tensor(params), fs, st, torch.tensor(hit_ref.reshape(hit_ref.shape[0], -1)),
                  _port_table(table), tpool, active, True)
    assert sr.stage_calls == calls + 1
    _agree(tb.state_to_numpy(st), out_ref, np.ones_like(alive), MIN_AGREE,
           f"float pool bounce {bounce}", exact_rows=(12, 13, 14, 15), close_rows=slice(0, 12))
