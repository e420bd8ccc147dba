"""K4's texture taps on the CPU.

On the card K4 (csrc/bounce.cu) samples the textured parameters and the
normal map itself; on a CPU state `shade_step` runs its twin, the texture
stage (ops/split_ref.py material_rows) and then ops/split_ref.py
shade_ref. Held here:

1. the new `shade_step` on a CPU state, from the JAX hit buffer, against
   the JAX package's `_material_rows` + `shade_step` in Pallas interpret
   mode: the small textured interior (3,840 triangles) on flattened and
   instanced tables, plain and normal-mapped, NEE off and on, and the
   textured Cornell box (resident); bounces 0 and 2 of a 1024-ray wave.
   State rows 12-15 bit-equal and rows 0-11 within rtol 1e-4 / atol 1e-5,
   each on 99.5 % of rays, as test_torch_split_bounce.py holds the twins
   (XLA's and PyTorch's cos/sin and x ** 2.4 differ in the last bits);
2. the pieces of the taps the kernel writes in C: the sRGB decode table
   against sample_pool's own decode on all 256 codes, bit for bit; the
   kernel's floor modulo (C's truncating % made a floor modulo) and wrap
   against `_wrap_coord` (the port's and the JAX package's) for negative
   and out-of-range coordinates on every WRAP_* mode; a float pool takes
   the FLT taps (TAP_FLOAT) and sample_pool's float branch;
3. chip_smoke.py's count of the distinct texel rows a K4 launch's taps
   read (its bound's texel bytes) against a brute-force count;
4. the opacity tap of the textured-cutout re-trace (render/material.py
   apply_textures on the hit buffer's rows, as ops/bounce.py
   retrace_round_ref, the twin of retrace_kernel, takes it) against the JAX
   `apply_textures(..., ("opacity",))` on seeded hits, over every wrap mode
   and channel, on a pool of mixed wraps and on an all-repeat pool (the
   2x2-row path), bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gatling_tpu.render.material as jmat
import gatling_tpu.render.texture as jtex

from gatling_tpu_torch import imgio

from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops import split_ref
from gatling_tpu_torch.render import texture as ttex
from gatling_tpu_torch.render import material as tmat
from gatling_tpu_torch.render.material import MaterialTable

from test_torch_clustered_bounce import port_tables
from test_torch_cuda import _chip_smoke
from test_torch_split_bounce import (MIN_AGREE, _agree, _port_pool, _port_table, jax_case,
                                     tex_dir)  # noqa: F401 (tex_dir: the fixture)

CASES = [(layout, tan, nee) for layout in ("flattened", "instanced")
         for tan in (False, True) for nee in (False, True)] + [("resident", False, False)]


@pytest.mark.parametrize("layout,tangents,nee", CASES)
@pytest.mark.parametrize("bounce", [0, 2])
def test_shade_step_taps_match_jax(tex_dir, layout, tangents, nee, bounce):  # noqa: F811
    scene, static, table, pool, active, steps = jax_case(layout, tangents, nee, tex_dir)
    params, state_in, hit_ref, _par, _hit_n, out_ref = steps[bounce]
    fs = port_tables(scene, static)
    st = tb.state_from_numpy(state_in, "cpu")
    alive = st[13].numpy() > 0.5
    assert alive.sum() > 300 and (hit_ref.shape[0] == 24) == tangents
    calls = split_ref.stage_calls
    # K3's hit buffer as JAX wrote it, before any normal map
    tb.shade_step(torch.tensor(params), fs, st, torch.tensor(hit_ref.reshape(hit_ref.shape[0], -1)),
                  _port_table(table), _port_pool(pool), active, nee)
    assert split_ref.stage_calls == calls + 1  # a CPU state runs the texture stage
    _agree(tb.state_to_numpy(st), out_ref, np.ones_like(alive), MIN_AGREE,
           f"{layout} tangents={tangents} nee={nee} bounce {bounce}",
           exact_rows=(12, 13, 14, 15), close_rows=slice(0, 12))


def _i32(a):
    return torch.tensor(np.asarray(a, np.uint32).view(np.int32))


def test_srgb_table_matches_the_taps():
    """srgb_table, which K4 reads in place of a pow, equals sample_pool's
    decode of every 8-bit code bit for bit: a 256x1 sRGB texture whose
    texel k holds code k in every channel, tapped at its texel centres
    (weights 1 and 0), and the decode of code / 255 directly."""
    codes = np.arange(256, dtype=np.uint32)
    texels = codes | (codes << 8) | (codes << 16) | (codes << 24)
    pool = ttex.TexturePool(
        texels=torch.zeros((1, 4)),
        texels_u32=_i32(np.concatenate([texels, [0]])), texels_q22=_i32(np.zeros((1, 4))),
        is_srgb=_i32([1]), offset=_i32([0]), width=_i32([256]), height=_i32([1]),
        wrap_s=_i32([ttex.WRAP_CLAMP]), wrap_t=_i32([ttex.WRAP_CLAMP]),
        scale=torch.ones((1, 4)), bias=torch.zeros((1, 4)), mean=torch.zeros((1, 4)))
    u = (torch.arange(256, dtype=torch.float32) + 0.5) / 256
    assert torch.equal(u * 256 - 0.5, torch.arange(256, dtype=torch.float32))
    tapped = ttex.sample_pool(pool, torch.zeros(256, dtype=torch.int32),
                              torch.stack([u, torch.full_like(u, 0.5)], -1))
    lut = ttex.srgb_table("cpu")
    assert lut.dtype == torch.float32 and lut.shape == (256,)
    for k in range(3):
        assert torch.equal(tapped[:, k].view(torch.int32), lut.view(torch.int32))
    code_f = torch.arange(256).to(torch.float32) * (1.0 / 255.0)
    assert torch.equal(tapped[:, 3], code_f)  # alpha is never decoded
    direct = ttex.srgb_decode(code_f)
    assert torch.equal(direct.view(torch.int32), lut.view(torch.int32))
    assert float(lut[0]) == 0.0 and float(lut[255]) == 1.0


def c_floor_mod(a: np.ndarray, b):
    """csrc/bounce.cu floor_mod: C's % (truncating, as np.fmod) made a floor
    modulo."""
    r = np.fmod(a, b)
    return np.where((r != 0) & ((r < 0) != (np.asarray(b) < 0)), r + b, r)


def c_wrap_coord(x: np.ndarray, size: int, mode: int):
    """csrc/bounce.cu wrap_coord, step for step."""
    s = max(size, 1)
    rep = c_floor_mod(x, s)
    clamped = np.minimum(np.maximum(x, 0), s - 1)
    period = c_floor_mod(x, 2 * s)
    mirrored = np.where(period < s, period, 2 * s - 1 - period)
    valid = (mode != ttex.WRAP_BLACK) | ((x >= 0) & (x < s))
    idx = {ttex.WRAP_REPEAT: rep, ttex.WRAP_CLAMP: clamped,
           ttex.WRAP_MIRROR: mirrored}.get(mode, clamped)
    return idx, valid


@pytest.mark.parametrize("mode", [ttex.WRAP_BLACK, ttex.WRAP_CLAMP, ttex.WRAP_REPEAT,
                                  ttex.WRAP_MIRROR])
def test_floor_modulo_wrap_matches_wrap_coord(mode):
    """The kernel's wrap equals _wrap_coord (the port's, and the JAX
    package's) for coordinates from five periods below 0 to five above the
    size, on sizes 1 to 64; C's own % alone would not (it truncates toward
    zero, so a negative x0 would not wrap to size - 1)."""
    for size in (1, 2, 3, 7, 64):
        x = np.arange(-5 * size - 3, 6 * size + 3, dtype=np.int32)
        idx, valid = c_wrap_coord(x, size, mode)
        t_idx, t_valid = ttex._wrap_coord(torch.tensor(x), torch.full((x.size,), size,
                                                                      dtype=torch.int32),
                                          torch.full((x.size,), mode, dtype=torch.int32))
        np.testing.assert_array_equal(idx, t_idx.numpy())
        np.testing.assert_array_equal(valid, t_valid.numpy())
        j_idx, j_valid = jtex._wrap_coord(jnp.asarray(x), jnp.full((x.size,), size, jnp.int32),
                                          jnp.full((x.size,), mode, jnp.int32))
        np.testing.assert_array_equal(idx, np.asarray(j_idx))
        np.testing.assert_array_equal(valid, np.broadcast_to(np.asarray(j_valid), x.shape))
        if size > 1:
            assert (np.fmod(x, size) != c_floor_mod(x, size)).any()


def test_float_pool_raises():
    """A pool with textures but no 8-bit texels (the float pool of the HDR
    codecs) no longer raises: K4 takes its FLT taps (TAP_FLOAT in the
    mask) and the twin sample_pool's float branch, which reads `texels`;
    the empty pool of an untextured anisotropic scene taps nothing."""
    empty = ttex.empty_pool()
    float_pool = empty._replace(texels=torch.tensor([[0.5, 2.0, 4.0, 1.0], [1.5, 0.0, 8.0, 0.25]]),
                                is_srgb=_i32([0, 0]), offset=_i32([0, 1]), width=_i32([1, 1]),
                                height=_i32([1, 1]), wrap_s=_i32([ttex.WRAP_REPEAT] * 2),
                                wrap_t=_i32([ttex.WRAP_CLAMP] * 2), scale=torch.ones((2, 4)),
                                bias=torch.zeros((2, 4)))
    assert float_pool.count == 2 and not float_pool.packed and float_pool.has_texels
    assert tb.tap_mask(1, 16, float_pool) == 1 | tb.TAP_FLOAT
    got = ttex.sample_pool(float_pool, torch.tensor([0, 1], dtype=torch.int32),
                           torch.full((2, 2), 0.5))
    assert torch.equal(got, float_pool.texels)  # a 1x1 slot's tap is its texel
    assert tb.tap_mask(15, 24, empty) == 0


@pytest.mark.parametrize("packed", [True, False])
def test_distinct_texel_count_matches_brute_force(packed):
    """chip_smoke.py tap_texel_rows (the distinct texel rows of a K4
    launch's taps: its bound's texel bytes) against a count in plain
    Python over every tap of a small wave: 2x2 rows of a repeat pool, or
    the texels a wrap keeps of a pool with other wraps; uv from -2 to 3,
    three slots over four materials (one untextured), base colour,
    roughness and the normal map tapped."""
    cs = _chip_smoke()
    rng = np.random.default_rng(4)
    sizes = [(5, 3), (16, 16), (7, 2)]
    offsets = np.cumsum([0] + [w * h for w, h in sizes])[:-1]
    n = int(sum(w * h for w, h in sizes))
    modes = ([ttex.WRAP_REPEAT] * 3 if packed
             else [ttex.WRAP_BLACK, ttex.WRAP_MIRROR, ttex.WRAP_CLAMP])
    pool = ttex.TexturePool(
        texels=torch.zeros((1, 4)),
        texels_u32=_i32(rng.integers(0, 2 ** 32, n + 1, dtype=np.uint64)),
        texels_q22=_i32(rng.integers(0, 2 ** 32, (n + 1, 4), dtype=np.uint64) if packed
                        else np.zeros((1, 4))),
        is_srgb=_i32([0, 1, 0]), offset=_i32(offsets), width=_i32([w for w, _ in sizes]),
        height=_i32([h for _, h in sizes]), wrap_s=_i32(modes), wrap_t=_i32(modes[::-1]),
        scale=torch.ones((3, 4)), bias=torch.zeros((3, 4)), mean=torch.zeros((3, 4)))
    pi = np.full((4, 10), -1, np.int32)
    pi[:, 6:9] = 0
    pi[0, [0, 3, 5]] = (0, 1, 2)  # base colour, roughness, normal map
    pi[1, [0, 5]] = (1, 0)
    pi[2, 3] = 2
    mats = MaterialTable(torch.zeros((4, 30)), torch.tensor(pi))
    r = 300
    hit = torch.zeros((24, r))
    hit[0] = torch.tensor((rng.random(r) < 0.8).astype(np.float32))
    hit[4] = torch.tensor(rng.integers(0, 4, r).astype(np.float32))
    hit[2:4] = torch.tensor(rng.uniform(-2.0, 3.0, (2, r)).astype(np.float32))
    textured = tb.TAP_BITS["base_color"] | tb.TAP_BITS["roughness"]
    got, row_bytes = cs.tap_texel_rows(mats, pool, hit, textured)
    assert row_bytes == (16 if packed else 4)

    want = set()
    h32 = hit.numpy()
    for i in range(r):
        if h32[0, i] <= 0.5:
            continue
        m = int(np.clip(np.rint(h32[4, i]), 0, 3))
        for col in (0, 3, 5):
            slot = pi[m, col]
            if slot < 0:
                continue
            w, h = sizes[slot]
            x = np.float32(h32[2, i]) * np.float32(w) - np.float32(0.5)
            y = (np.float32(1.0) - np.float32(h32[3, i])) * np.float32(h) - np.float32(0.5)
            x0, y0 = math.floor(x), math.floor(y)
            if packed:
                want.add(int(offsets[slot]) + (y0 % h) * w + x0 % w)
                continue
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                xi, vx = c_wrap_coord(np.array([x0 + dx]), w, modes[slot])
                yi, vy = c_wrap_coord(np.array([y0 + dy]), h, modes[::-1][slot])
                if vx[0] and vy[0]:
                    want.add(int(offsets[slot]) + int(yi[0]) * w + int(xi[0]))
    assert len(want) > 20
    assert sorted(got.tolist()) == sorted(want)


# (channel, wrap_s, wrap_t) of each opacity-textured material: every wrap
# mode and channel, or all repeat (the pool's 2x2 rows)
OPACITY_SLOTS = {
    "wraps": [("r", "repeat", "clamp"), ("g", "clamp", "mirror"), ("b", "mirror", "black"),
              ("a", "black", "repeat")],
    "repeat": [("a", "repeat", "repeat"), ("r", "repeat", "repeat")],
}


@pytest.mark.parametrize("pool_kind", sorted(OPACITY_SLOTS))
def test_opacity_tap_row_matches_jax(tmp_path, pool_kind):
    rng = np.random.default_rng(17)
    png = str(tmp_path / "opacity.png")
    imgio.write_image_file(png, rng.integers(0, 256, (13, 9, 4)).astype(np.uint8))

    def lowered(lib, tex):
        rows = []
        for k, (ch, ws, wt) in enumerate(OPACITY_SLOTS[pool_kind]):
            m = lib.lower_material(None)
            m.textures["opacity"] = tex.TextureRef(
                file_path=png, wrap_s=ws, wrap_t=wt, channel=ch,
                scale=(0.9, 1.1, 0.8, 1.2), bias=(0.05, -0.1, 0.1, -0.05))
            m.params.update(opacity_threshold=0.5 if k % 2 else 0.0)
            rows.append(m)
        m = lib.lower_material(None)
        m.params.update(opacity=0.3)  # untextured: the table's opacity
        return rows + [m]

    jt, jp = jmat.build_materials(lowered(jmat, jtex))
    tt, tp = tmat.build_materials(lowered(tmat, ttex))
    assert tp.bilinear_packed == (pool_kind == "repeat")
    r = 4096
    n_mats = len(OPACITY_SLOTS[pool_kind]) + 1
    mat = rng.integers(0, n_mats, r).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (r, 2)).astype(np.float32)
    hit = torch.zeros((split_ref.HIT_ROWS, r))
    hit[split_ref.H_HIT] = torch.tensor((rng.random(r) < 0.9).astype(np.float32))
    hit[split_ref.H_MAT] = torch.tensor(mat.astype(np.float32))
    hit[split_ref.H_UVX:split_ref.H_UVY + 1] = torch.tensor(uv.T.copy())
    tt = tt.to("cpu")
    mat_t = torch.clamp(torch.round(hit[split_ref.H_MAT]).long(), 0, tt.packed_f.shape[0] - 1)
    uv_t = torch.stack([hit[split_ref.H_UVX], hit[split_ref.H_UVY]], dim=-1)
    got = tmat.apply_textures(tt, tp, tmat.gather_params(tt, mat_t), mat_t, uv_t,
                              ("opacity",)).opacity.numpy()
    assert got.shape == (r,)
    ref = jmat.apply_textures(jt, jp, jmat.gather_params(jt, jnp.asarray(mat)),
                              jnp.asarray(mat), jnp.asarray(uv), ("opacity",))
    hit_rays = hit[split_ref.H_HIT].numpy() > 0.5
    np.testing.assert_array_equal(got[hit_rays], np.asarray(ref.opacity)[hit_rays])
    untextured = hit_rays & (mat == n_mats - 1)
    assert untextured.any() and (got[untextured] == np.float32(0.3)).all()
    # without "opacity" among the textured parameters the round takes the table's
    plain = tmat.gather_params(tt, mat_t).opacity
    np.testing.assert_array_equal(plain.numpy(), tt.packed_f[mat, tmat.MF_OPACITY])
