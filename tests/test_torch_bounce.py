"""The port's bounce twin (gatling_tpu_torch/ops/bounce_ref.py) against the
JAX package's resident `bounce_step`, run in Pallas interpret mode.

Both sides get identical packed ray state and scene tables (the JAX
FusedScene arrays carried over with from_jax_tables). Rows 12-15 (rng
bits, alive flag, miss record, segment count) must be bit-equal; rows 0-11
(origin, direction, throughput, radiance) agree to rtol 1e-4 / atol 1e-5 on
at least 99.9 % of rays: the two differ in transcendental functions (XLA's
and PyTorch's cos/sin/log) and in rsqrt versus 1/sqrt, which can flip a
hit/miss or lobe decision on a ray that sits exactly on an edge.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gatling_tpu.ops.geometry import build_geometry
from gatling_tpu.ops.pallas_bounce import (
    build_fused_scene, bounce_step, make_params, pack_state)
from gatling_tpu.render.camera import CameraUniforms, generate_primary_rays
from gatling_tpu.render.integrator import RenderConfig, Uniforms
from gatling_tpu.render.lights import build_light_arrays
from gatling_tpu.render.material import build_material_table, lower_material
from gatling_tpu.ops import sampling as smp
from gatling_tpu.scene.stage import LightDesc, load_scene

from gatling_tpu_torch.ops import bounce as tb

CORNELL = "tests/data/cornell.usda"
ANALYTIC = "tests/graphical/Lights.Analytic/scene.usda"
RTOL, ATOL, MIN_AGREE = 1e-4, 1e-5, 0.999


def rect_light() -> LightDesc:
    """The rect light of tests/test_fused.py: under the cornell ceiling,
    emitting down (-Z)."""
    xf = np.eye(4)
    xf[3, :3] = [0.0, 0.0, 0.9]
    return LightDesc(
        path="/neelight", light_type="rect", transform=xf,
        params=dict(intensity=4.0, exposure=0.0,
                    color=np.array([1.0, 0.9, 0.8], np.float32),
                    normalize=False, diffuse=1.0, specular=1.0,
                    enableColorTemperature=False, colorTemperature=6500.0,
                    width=0.8, height=0.6))


def jax_setup(path, extra_lights=()):
    """JAX package tables + uniforms for a scene file."""
    desc = load_scene(path)
    mat_paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(mat_paths)}
    midx[None] = len(mat_paths)
    geom = build_geometry(desc.meshes, midx)
    rows = [None] * len(midx)
    for p, i in midx.items():
        rows[i] = lower_material(desc.materials.get(p) if p else None)
    table = build_material_table(rows)
    lights = [l for l in desc.lights if l.light_type != "dome"] + list(extra_lights)
    scene, static = build_fused_scene(geom, table, build_light_arrays(lights))
    cam = desc.first_camera()
    uni = Uniforms(
        camera=CameraUniforms(
            jnp.asarray(cam.position), jnp.asarray(cam.forward), jnp.asarray(cam.up),
            jnp.float32(cam.vfov), jnp.float32(0), jnp.float32(0), jnp.float32(0),
            jnp.float32(cam.clip_start), jnp.float32(cam.clip_end)),
        sample_offset=jnp.int32(0), inv_total_sample_count=jnp.float32(1.0),
        max_sample_value=jnp.float32(10), rr_inv_min_term_prob=jnp.float32(0.95),
        light_intensity_multiplier=jnp.float32(1), meters_per_scene_unit=jnp.float32(1),
        max_volume_walk_length=jnp.int32(7),
        dome_rotation=jnp.asarray([0, 0, 0, 1.0], jnp.float32),
        dome_emission_multiplier=jnp.ones(3, jnp.float32),
        dome_diffuse_specular=jnp.ones(2, jnp.float32))
    return scene, static, uni


def primary_state(uni, w, h, seed):
    """Packed JAX state of one jittered, filter-importance-sampled camera
    sample per pixel of a w x h frame; the sample index comes from a numpy
    seed."""
    pix = jnp.arange(w * h, dtype=jnp.int32)
    sidx = int(np.random.default_rng(seed).integers(0, 1 << 20))
    rng = smp.rng_init(pix.astype(jnp.uint32), jnp.uint32(sidx))
    o, d, rng = generate_primary_rays(uni.camera, w, h, pix % w, pix // w, rng,
                                      True, True, False)
    return pack_state(o, d, rng, w * h)


def compare_states(ref: np.ndarray, got: np.ndarray, label: str) -> None:
    ref = ref.reshape(16, -1)
    got = got.reshape(16, -1)
    n = ref.shape[1]
    np.testing.assert_array_equal(got[12].view(np.int32), ref[12].view(np.int32),
                                  err_msg=f"{label}: rng row")
    for row in (13, 14, 15):
        np.testing.assert_array_equal(got[row], ref[row], err_msg=f"{label}: row {row}")
    close = np.isclose(got[:12], ref[:12], rtol=RTOL, atol=ATOL).all(axis=0)
    outside = int(n - close.sum())
    print(f"{label}: {outside} of {n} rays outside rtol {RTOL} / atol {ATOL} on rows 0-11")
    assert close.mean() >= MIN_AGREE, (label, outside)


CASES = {
    "cornell": (CORNELL, (), False, 32, 32),
    "cornell_nee": (CORNELL, (rect_light(),), True, 32, 32),
    "analytic_nee": (ANALYTIC, (), True, 64, 32),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """JAX states at bounce 0 and bounce 4 (stepped by the JAX kernel), and
    the JAX kernel's output for each, for one scene."""
    path, extra, nee, w, h = CASES[request.param]
    scene, static, uni = jax_setup(path, extra)
    cfg = RenderConfig(width=w, height=h, has_dome=False, nee=nee)
    state = primary_state(uni, w, h, seed=len(request.param))
    steps = {}
    # each interpreted kernel finishes before the next dispatch: a dispatch
    # while the interpreter's callbacks run can deadlock
    with pltpu.force_tpu_interpret_mode():
        for b in range(5):
            params = make_params(cfg, uni, jnp.int32(b))
            out = jax.block_until_ready(bounce_step(params, scene, state, static=static,
                                                    nee=nee))
            if b in (0, 4):
                steps[b] = (np.asarray(params), np.asarray(state), np.asarray(out))
            state = out
    return request.param, scene, static, nee, steps


def test_state_and_params_pack_like_jax():
    """pack_state and make_params give JAX's bytes; the state round-trips
    through the JAX layout [16, R/128, 128]."""
    rng = np.random.default_rng(7)
    r, r_pad = 1000, 1024
    o = rng.normal(size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    seeds = rng.integers(0, 1 << 32, size=r, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(pack_state(jnp.asarray(o), jnp.asarray(d), jnp.asarray(seeds), r_pad))
    got = tb.pack_state(torch.tensor(o), torch.tensor(d), torch.tensor(seeds.astype(np.int64)),
                        r_pad)
    assert tb.state_to_numpy(got).shape == ref.shape
    np.testing.assert_array_equal(tb.state_to_numpy(got).view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(tb.state_from_numpy(ref, "cpu").numpy().view(np.int32),
                                  got.numpy().view(np.int32))

    _scene, _static, uni = jax_setup(CORNELL)
    uni = uni._replace(camera=uni.camera._replace(sensor_exposure=jnp.float32(0.37)),
                       rr_inv_min_term_prob=jnp.float32(0.8),
                       light_intensity_multiplier=jnp.float32(1.7))
    cfg = RenderConfig(width=8, height=8, rr_bounce_offset=2)
    from gatling_tpu_torch.render.camera import CameraUniforms as TCam
    from gatling_tpu_torch.render.integrator import RenderConfig as TConfig
    from gatling_tpu_torch.render.integrator import Uniforms as TUniforms
    tuni = TUniforms(camera=TCam(None, None, None, 0.4, 0.0, 0.0, 0.37, 0.1, 100.0),
                     sample_offset=0, inv_total_sample_count=1.0, max_sample_value=10.0,
                     rr_inv_min_term_prob=float(np.float32(0.8)),
                     light_intensity_multiplier=float(np.float32(1.7)),
                     meters_per_scene_unit=1.0, max_volume_walk_length=7)
    rows = tb.make_params(TConfig(width=8, height=8, rr_bounce_offset=2), tuni, 5, "cpu").numpy()
    for b in range(5):
        jref = np.asarray(make_params(cfg, uni, jnp.int32(b)))
        np.testing.assert_array_equal(rows[b].view(np.int32), jref.view(np.int32))


@pytest.mark.parametrize("bounce", [0, 4])
def test_twin_matches_jax_bounce_step(case, bounce):
    label, scene, static, nee, steps = case
    params, state_in, ref = steps[bounce]
    fs = tb.from_jax_tables(np.asarray(scene.tris), np.asarray(scene.mats),
                            np.asarray(scene.lights), static.light_types, "cpu")
    st = tb.state_from_numpy(state_in, "cpu")
    tb.bounce_step(torch.tensor(params), fs, st, nee)
    got = tb.state_to_numpy(st)
    compare_states(ref, got, f"{label} bounce {bounce}")
    # the bounce did work: rays were alive going in and some traced
    assert (state_in.reshape(16, -1)[13] > 0.5).any()
    assert got.reshape(16, -1)[15].sum() > state_in.reshape(16, -1)[15].sum()

