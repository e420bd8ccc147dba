"""The peel's taps and the textured-cutout re-trace round against the JAX
package, on the CPU.

`tap_rows` computes only the rows the bounce-0 peel reads, and one round
of the textured-cutout re-trace is one call, `retrace_round` (K4r on the
card). Held here, over seeded hit buffers on an 8-bit pool (mixed wraps,
channels and thresholds) and a float one (the same materials with an EXR
among the slots):

1. `tap_rows_ref` against the JAX texture stage
   (gatling_tpu/render/fused.py `_material_rows`): the base colour and
   metallic bit for bit on the hit rays, the normal-mapped normal (a hit
   buffer with tangent rows) within 1e-6: jnp.cross and jnp.linalg.norm
   round apart from torch's, as tests/test_torch_float_pool.py holds it;
2. `retrace_round_ref` against the JAX package's own re-trace
   (gatling_tpu/render/fused.py:302-359 `_textured_cutout_retrace`), its
   trace_step replaced by one that records the masked state of each round
   and hands back the hit buffer it was given: round by round, the masked
   alive row (the reject mask) and the moved origins bit for bit: XLA's
   CPU backend makes no fused multiply-add of offset_ray_origin's
   multiply and add, and PyTorch and the port's kernel (-fmad=false) make
   none either;
3. `textured_cutout_retrace` with the factored round against the loop as
   it stood before (its PyTorch round inline, a state clone a round), on a
   wave through the checker-masked screen of tests/test_cutout.py: the
   merged hit buffer and the state bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gatling_tpu.ops.pallas_bounce as jpb
import gatling_tpu.render.fused as jfused
import gatling_tpu.render.material as jmat
import gatling_tpu.render.texture as jtex
from gatling_tpu.render.fused import _material_rows as jmaterial_rows
from gatling_tpu.render.integrator import RenderConfig as JConfig

from gatling_tpu_torch import imgio
from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops import sampling as smp
from gatling_tpu_torch.ops import split_ref as sr
from gatling_tpu_torch.render import bsdf, fused
from gatling_tpu_torch.render import material as tmat
from gatling_tpu_torch.render import texture as ttex

from test_torch_clustered_bounce import primary_state, uniforms
from test_torch_cutout import _checker_png, _textured_cutout_case
from test_torch_lobes import port_tables
from test_torch_split_bounce import _port_pool, _port_table

R = 4096  # seeded hit rows
# (channel, wrap_s, wrap_t, threshold) of each opacity-textured material
OPACITY = [("r", "repeat", "clamp", 0.0), ("g", "clamp", "mirror", 0.5),
           ("b", "mirror", "black", 0.0), ("a", "black", "repeat", 0.5)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("retrace")
    rng = np.random.default_rng(31)
    out = {"png": str(d / "a.png"), "normal": str(d / "n.png"), "exr": str(d / "c.exr")}
    imgio.write_image_file(out["png"], rng.integers(0, 256, (13, 9, 4)).astype(np.uint8))
    imgio.write_image_file(out["normal"], rng.integers(0, 256, (7, 11, 4)).astype(np.uint8))
    imgio.write_image_file(out["exr"], rng.uniform(0.0, 1.5, (6, 10, 4)).astype(np.float32))
    return out


def lowered(lib, tex, files, pool_kind: str):
    """Materials with every tap: each opacity of OPACITY (the float pool's
    from the EXR), a textured base colour, metallic channel and normal map
    on some, and an untextured one (opacity 0.3)."""
    opac = files["exr"] if pool_kind == "float" else files["png"]
    rows = []
    for k, (ch, ws, wt, thresh) in enumerate(OPACITY):
        m = lib.lower_material(None)
        m.textures["opacity"] = tex.TextureRef(file_path=opac, wrap_s=ws, wrap_t=wt, channel=ch,
                                               scale=(0.9, 1.1, 0.8, 1.2),
                                               bias=(0.05, -0.1, 0.1, -0.05))
        m.params.update(opacity_threshold=thresh, metallic=0.25 * k)
        if k % 2:
            m.textures["base_color"] = tex.TextureRef(file_path=files["png"], wrap_s=ws)
            m.textures["normal"] = tex.TextureRef(file_path=files["normal"],
                                                  scale=(2.0, 2.0, 2.0, 1.0),
                                                  bias=(-1.0, -1.0, -1.0, 0.0))
        else:
            m.textures["metallic"] = tex.TextureRef(file_path=files["png"], channel="b",
                                                    wrap_t=wt)
        rows.append(m)
    m = lib.lower_material(None)
    m.params.update(opacity=0.3, base_color=(0.2, 0.5, 0.7))
    return rows + [m]


def tables(files, pool_kind: str):
    """(JAX table, JAX pool, port table, port pool, textured parameters)."""
    jrows = lowered(jmat, jtex, files, pool_kind)
    jt, jp = jmat.build_materials(jrows)
    tt, tp = tmat.build_materials(lowered(tmat, ttex, files, pool_kind))
    assert tp.packed == (pool_kind == "8bit")
    active = jmat.textured_params(jrows)
    assert set(active) == {"base_color", "metallic", "opacity"}
    return jt, jp, tt.to("cpu"), tp, active


def hit_rows(rows: int, n_mats: int, seed: int) -> np.ndarray:
    """A seeded hit buffer [rows, R]: 90 % hits, every material, uv from -2
    to 3, unit normals and tangents, bitangent signs, positions and
    geometric normals."""
    rng = np.random.default_rng(seed)
    hit = np.zeros((rows, R), np.float32)
    hit[sr.H_HIT] = rng.random(R) < 0.9
    hit[sr.H_MAT] = rng.integers(0, n_mats, R)
    hit[sr.H_UVX:sr.H_UVY + 1] = rng.uniform(-2.0, 3.0, (2, R))
    n = rng.normal(size=(3, R))
    n /= np.linalg.norm(n, axis=0)
    hit[sr.H_N:sr.H_N + 3] = n
    hit[sr.H_GN:sr.H_GN + 3] = n
    hit[sr.H_POS:sr.H_POS + 3] = rng.normal(scale=30.0, size=(3, R))
    hit[sr.H_POS, :64] = 0.0  # the offset's floor of 2^-16
    if rows > sr.HIT_ROWS:
        t = rng.normal(size=(3, R))
        t -= n * (t * n).sum(0)
        hit[sr.H_TAN:sr.H_TAN + 3] = t / np.linalg.norm(t, axis=0)
        hit[sr.H_BS] = np.where(rng.random(R) < 0.5, -1.0, 1.0)
    return hit


@pytest.mark.parametrize("pool_kind", ["8bit", "float"])
@pytest.mark.parametrize("tangents", [False, True])
def test_tap_rows_ref_matches_jax(files, pool_kind, tangents):
    jt, jp, tt, tp, active = tables(files, pool_kind)
    hit = hit_rows(sr.HIT_ROWS_TAN if tangents else sr.HIT_ROWS, tt.packed_f.shape[0], 7)
    shading = tuple(a for a in active if a != "opacity")
    stage = jmaterial_rows(jt, jp, jnp.asarray(hit.reshape(hit.shape[0], R // 128, 128)),
                           shading, return_params=True)
    p_ref = stage[-1]
    normal_ref = np.asarray(stage[1]).reshape(hit.shape[0], R)[sr.H_N:sr.H_N + 3] if tangents \
        else hit[sr.H_N:sr.H_N + 3]
    on = hit[sr.H_HIT] > 0.5
    got = tb.tap_rows_ref(torch.tensor(hit), tt, tp, active).numpy()
    assert got.shape == (tb.TAP_ROWS, R)
    np.testing.assert_array_equal(got[tb.TAP_BASE_ROW:tb.TAP_BASE_ROW + 3][:, on],
                                  np.asarray(p_ref.base_color).T[:, on])
    np.testing.assert_array_equal(got[tb.TAP_METAL_ROW][on], np.asarray(p_ref.metallic)[on])
    normal = got[tb.TAP_N_ROW:tb.TAP_N_ROW + 3][:, on]
    if tangents:
        np.testing.assert_allclose(normal, normal_ref[:, on], rtol=0, atol=1e-6)
        assert (normal != hit[sr.H_N:sr.H_N + 3][:, on]).any()  # mapped
    else:
        np.testing.assert_array_equal(normal, normal_ref[:, on])
    # the base colour and metallic are tapped: apart from the table's on some hit rays
    table = tt.packed_f[hit[sr.H_MAT].astype(np.int64)].numpy()
    assert (got[tb.TAP_BASE_ROW][on] != table[on, tmat.MF_BASE]).any()
    assert (got[tb.TAP_METAL_ROW][on] != table[on, tmat.MF_METAL]).any()


def jax_rounds(monkeypatch, jt, jp, state: np.ndarray, hit: np.ndarray):
    """The JAX package's re-trace (gatling_tpu/render/fused.py:302-359) on
    flat [16, R] state and hit rows, its trace_step recording each round's
    masked state and handing back the hit buffer it was given: (the masked
    states [16, R] of the rounds, the final state)."""
    shape = (R // 128, 128)
    hit3 = jnp.asarray(hit.reshape(hit.shape[0], *shape))
    masked = []

    def trace_step(params, scene, m, static):
        masked.append(np.asarray(m).reshape(16, R))
        return hit3

    monkeypatch.setattr(jfused, "trace_step", trace_step)
    _hb, out = jfused._textured_cutout_retrace(None, None, jnp.asarray(state.reshape(16, *shape)),
                                               hit3, static=None, materials=jt, textures=jp)
    return masked, np.asarray(out).reshape(16, R)


@pytest.mark.parametrize("pool_kind", ["8bit", "float"])
def test_retrace_round_ref_matches_jax_round(monkeypatch, files, pool_kind):
    jt, jp, tt, tp, active = tables(files, pool_kind)
    hit = hit_rows(sr.HIT_ROWS, tt.packed_f.shape[0], 11)
    rng = np.random.default_rng(12)
    state = rng.normal(size=(16, R)).astype(np.float32)
    state[12] = rng.integers(0, 1 << 32, R, dtype=np.uint64).astype(np.uint32).view(np.float32)
    state[13] = rng.choice(np.array([0.0, 1.0, 2.0, 0.25], np.float32), R)  # 2: in a medium
    masked_ref, state_ref = jax_rounds(monkeypatch, jt, jp, state, hit)
    assert len(masked_ref) == fused.TEX_CUTOUT_ROUNDS - 1
    st, masked = torch.tensor(state), torch.tensor(state)
    rejected = 0
    for rd, want in enumerate(masked_ref):
        before = st.clone()
        tb.retrace_round_ref(st, masked, torch.tensor(hit), tt, tp, active, rd)
        got = masked.numpy()
        np.testing.assert_array_equal(got[13].view(np.int32), want[13].view(np.int32))
        np.testing.assert_array_equal(got[0:3].view(np.int32), want[0:3].view(np.int32))
        np.testing.assert_array_equal(st.numpy()[3:], state[3:])
        np.testing.assert_array_equal(got[:13], st.numpy()[:13])
        reject = got[13] > 0.5
        np.testing.assert_array_equal(st.numpy()[0:3][:, ~reject], before.numpy()[0:3][:, ~reject])
        rejected += int(reject.sum())
    np.testing.assert_array_equal(st.numpy().view(np.int32), state_ref.view(np.int32))
    assert 200 < rejected < R  # every round draws, and some rays pass


def parent_retrace(params, scene, state, hitbuf, materials, textures, textured_params):
    """textured_cutout_retrace as it stood before retrace_round: the round's
    PyTorch ops inline, the state cloned and masked each round."""
    salt = smp.f32_bits_to_u32(state[12])
    has_slot = materials.packed_i[:, tmat.MI_OPACITY_TEX] >= 0
    for rnd in range(fused.TEX_CUTOUT_ROUNDS - 1):
        mat = fused._hit_materials(hitbuf, materials)
        p = tmat.gather_params(materials, mat)
        if "opacity" in textured_params:
            uv = torch.stack([hitbuf[sr.H_UVX], hitbuf[sr.H_UVY]], dim=-1)
            p = tmat.apply_textures(materials, textures, p, mat, uv, ("opacity",))
        reject = ((state[13] > 0.5) & (hitbuf[sr.H_HIT] > 0.5) & has_slot[mat]
                  & (tb.retrace_draws(salt, rnd) >= bsdf.cutout_opacity(p)))
        past = smp.offset_ray_origin(hitbuf[sr.H_POS:sr.H_POS + 3].T,
                                     -hitbuf[sr.H_GN:sr.H_GN + 3].T)
        state[0:3] = torch.where(reject, past.T, state[0:3])
        masked = state.clone()
        masked[13] = torch.where(reject, state[13], 0.0)
        hitbuf = torch.where(reject, tb.trace_step(params, scene, masked), hitbuf)
    return hitbuf


def test_textured_cutout_retrace_matches_the_inline_round(tmp_path):
    png = _checker_png(tmp_path / "checker.png")
    scene, static, table, pool, active = _textured_cutout_case(png, False)
    fs = port_tables(scene, static)
    mats, tp = _port_table(table), _port_pool(pool)
    juni = uniforms((0.0, 0.0, 5.0), (0.02, 0.01, -1.0), vfov=0.3)
    params = torch.tensor(np.asarray(jpb.make_params(JConfig(width=32, height=32, has_dome=False),
                                                     juni, jnp.int32(0))))
    state = tb.state_from_numpy(np.asarray(primary_state(juni, seed=4)), "cpu")
    hit = tb.trace_step(params, fs, state)
    st1, st2 = state.clone(), state.clone()
    got = fused.textured_cutout_retrace(params, fs, st1, hit.clone(), mats, tp, active)
    want = parent_retrace(params, fs, st2, hit.clone(), mats, tp, active)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
    np.testing.assert_array_equal(st1.numpy().view(np.int32), st2.numpy().view(np.int32))
    moved = (st1[0:3] != state[0:3]).any(dim=0)
    assert 100 < int(moved.sum()) < state.shape[1]  # the checker passes about half
    assert bool((got[sr.H_MAT][moved] != hit[sr.H_MAT][moved]).any())  # the wall behind
