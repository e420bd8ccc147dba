"""The port's two-level walk (the K2 twin in ops/bounce_ref.py) against the
JAX package's clustered and instanced `bounce_step` in Pallas interpret
mode, and against its own resident walk.

Both sides get identical packed ray states (a camera wave stepped by the
JAX kernel) and identical tables (the JAX FusedScene arrays carried over
with from_jax_tables). Rows 12-15 must be bit-equal (row 12 as int32) and
rows 0-11 agree to rtol 1e-4 / atol 1e-5, each on at least 99.5 % of
rays: the JAX walk decides its winners with bf16 hi/lo products (about
2^-16 relative), the port in f32, so a ray whose two nearest candidates
lie closer than that may take the other one. The port-only checks (its
flattened walk against its resident walk on the same triangles, its
instanced walk against its flattened walk) hold to 99.9 %.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gatling_tpu.ops.geometry as jgeom
import gatling_tpu.ops.pallas_bounce as jpb
from gatling_tpu.ops import sampling as jsmp
from gatling_tpu.render.camera import CameraUniforms, generate_primary_rays
from gatling_tpu.render.integrator import RenderConfig, Uniforms
from gatling_tpu.render.lights import build_light_arrays as jlight_arrays

import gatling_tpu_torch.ops.geometry as tgeom
from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.render.lights import build_light_arrays as tlight_arrays

from test_torch_bounce import rect_light
from test_torch_clustered_scene import TORCH, SCENES, materials, scene_pair

RTOL, ATOL = 1e-4, 1e-5
MIN_AGREE_JAX, MIN_AGREE_PORT = 0.995, 0.999
W = H = 32  # 1024 rays: one JAX kernel block


def uniforms(pos, fwd, vfov=0.9) -> Uniforms:
    fwd = np.asarray(fwd, np.float64) / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0]) - fwd * fwd[2]
    up /= np.linalg.norm(up)
    return Uniforms(
        camera=CameraUniforms(jnp.asarray(pos, jnp.float32), jnp.asarray(fwd, jnp.float32),
                              jnp.asarray(up, jnp.float32), jnp.float32(vfov), jnp.float32(0),
                              jnp.float32(0), jnp.float32(0), jnp.float32(0.01),
                              jnp.float32(1e5)),
        sample_offset=jnp.int32(0), inv_total_sample_count=jnp.float32(1.0),
        max_sample_value=jnp.float32(10), rr_inv_min_term_prob=jnp.float32(0.95),
        light_intensity_multiplier=jnp.float32(1), meters_per_scene_unit=jnp.float32(1),
        max_volume_walk_length=jnp.int32(7),
        dome_rotation=jnp.asarray([0, 0, 0, 1.0], jnp.float32),
        dome_emission_multiplier=jnp.ones(3, jnp.float32),
        dome_diffuse_specular=jnp.ones(2, jnp.float32))


CAMERAS = {  # position, forward
    "cornell": ((0.0, -7.0, 0.0), (0.0, 1.0, 0.0)),
    "three_spheres": ((0.5, -7.0, 2.5), (0.0, 1.0, -0.35)),
    # inside the middle sphere: about 900 of 1024 rays still alive at bounce 4
    "inside_sphere": ((0.0, 0.0, 0.0), (0.3, 1.0, 0.2)),
    "instanced_field": ((-1.5, -4.0, 4.0), (0.2, 0.4, -0.6)),
}


def jax_tables(name: str, nee: bool, instanced: bool):
    """JAX tables of a scene: clustered (resident_max=0) or instanced."""
    (jm, jidx, jtable), _ = scene_pair(name)
    lights = jlight_arrays([rect_light()]) if nee else None
    if instanced:
        return jpb.build_fused_scene_instanced(jm, jidx, jtable, lights, min_gain=1.5,
                                               min_flat=0)
    return jpb.build_fused_scene(jgeom.build_geometry(jm, jidx), jtable, lights,
                                 resident_max=0)


def port_tables(scene, static, device="cpu"):
    """The port's device tables carrying the JAX arrays."""
    kw = {}
    if static.clustered:
        kw = dict(l1=np.asarray(scene.l1_aabbs), l2=np.asarray(scene.l2_aabbs))
    if static.instanced:
        kw.update(inst_map=np.asarray(scene.inst_map), inst_attr=np.asarray(scene.inst_attr))
    return tb.from_jax_tables(np.asarray(scene.tris), np.asarray(scene.mats),
                              np.asarray(scene.lights), static.light_types, device, **kw)


def primary_state(uni, seed: int):
    pix = jnp.arange(W * H, dtype=jnp.int32)
    sidx = int(np.random.default_rng(seed).integers(0, 1 << 20))
    rng = jsmp.rng_init(pix.astype(jnp.uint32), jnp.uint32(sidx))
    o, d, rng = generate_primary_rays(uni.camera, W, H, pix % W, pix // W, rng,
                                      True, True, False)
    return jpb.pack_state(o, d, rng, W * H)


def outside(ref: np.ndarray, got: np.ndarray) -> tuple[int, int]:
    """(rays with rows 12-15 not bit-equal, rays outside tolerance on 0-11)."""
    ref, got = ref.reshape(16, -1), got.reshape(16, -1)
    bits = (got[12:].view(np.int32) != ref[12:].view(np.int32)).any(axis=0)
    close = np.isclose(got[:12], ref[:12], rtol=RTOL, atol=ATOL).all(axis=0)
    return int(bits.sum()), int((~close).sum())


def check(ref, got, label, min_agree):
    n = ref.reshape(16, -1).shape[1]
    bits, out = outside(ref, got)
    print(f"{label}: {bits} of {n} rays with rows 12-15 not bit-equal, {out} outside "
          f"rtol {RTOL} / atol {ATOL} on rows 0-11")
    assert bits <= n * (1 - min_agree), (label, bits)
    assert out <= n * (1 - min_agree), (label, out)


CASES = {  # scene, camera, instanced, nee, bounces compared
    "cornell_clustered": ("cornell", "cornell", False, False, (0, 4)),
    "cornell_clustered_nee": ("cornell", "cornell", False, True, (0, 4)),
    "three_spheres": ("three_spheres", "three_spheres", False, False, (0,)),
    "three_spheres_nee": ("three_spheres", "three_spheres", False, True, (0,)),
    # from outside, every ray has left the three spheres by bounce 3
    "three_spheres_inside": ("three_spheres", "inside_sphere", False, False, (4,)),
    "three_spheres_inside_nee": ("three_spheres", "inside_sphere", False, True, (4,)),
    "instanced_field": ("instanced_field", "instanced_field", True, False, (0, 4)),
    "instanced_field_nee": ("instanced_field", "instanced_field", True, True, (0, 4)),
}


@functools.lru_cache(maxsize=None)
def jax_steps(label: str):
    """The JAX tables of a case, and for each compared bounce the params,
    the state going in (a camera wave stepped by the JAX kernel) and the
    JAX kernel's output."""
    name, camera, instanced, nee, bounces = CASES[label]
    scene, static = jax_tables(name, nee, instanced)
    assert static.clustered and static.instanced == instanced
    uni = uniforms(*CAMERAS[camera])
    cfg = RenderConfig(width=W, height=H, has_dome=False, nee=nee)
    state = primary_state(uni, seed=len(label))
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
    return scene, static, steps


@pytest.mark.parametrize("label,bounce", [(k, b) for k, v in CASES.items() for b in v[4]])
def test_walk_twin_matches_jax_bounce_step(label, bounce):
    nee = CASES[label][3]
    scene, static, steps = jax_steps(label)
    params, state_in, ref = steps[bounce]
    fs = port_tables(scene, static)
    st = tb.state_from_numpy(state_in, "cpu")
    tb.bounce_step(torch.tensor(params), fs, st, nee)
    got = tb.state_to_numpy(st)
    check(ref, got, f"{label} bounce {bounce}", MIN_AGREE_JAX)
    s_in, s_out = state_in.reshape(16, -1), got.reshape(16, -1)
    alive_in = int((s_in[13] > 0.5).sum())
    assert alive_in > 30  # the bounce did work
    if nee and bounce == 0:  # and traced shadow rays
        assert s_out[15].sum() - s_in[15].sum() - alive_in > 30


def _port_wave(name, nee, seed=5):
    """A port state of the scene's camera wave and the port's params."""
    uni = uniforms(*CAMERAS[name])
    state = tb.state_from_numpy(np.asarray(primary_state(uni, seed)), "cpu")
    cfg = RenderConfig(width=W, height=H, has_dome=False, nee=nee)
    params = [torch.tensor(np.asarray(jpb.make_params(cfg, uni, jnp.int32(b))))
              for b in range(5)]
    return state, params


def _step_compare(a, b, name, nee, label):
    """Step one wave through tables a (the reference) for bounces 0-4; at
    bounces 0 and 4 hold tables b's step from the same state against it."""
    state, params = _port_wave(name, nee)
    for bnc in range(5):
        ref = state.clone()
        tb.bounce_step(params[bnc], a, ref, nee)
        if bnc in (0, 4):
            got = state.clone()
            tb.bounce_step(params[bnc], b, got, nee)
            check(ref.numpy(), got.numpy(), f"{label} bounce {bnc}", MIN_AGREE_PORT)
        state = ref


@pytest.mark.parametrize("name,nee", [("cornell", False), ("cornell", True),
                                      ("three_spheres", True)])
def test_walk_twin_matches_resident_twin(name, nee):
    """The flattened walk against the resident walk over the same triangles."""
    (_jm, _ji, _jt), (tm, tidx, ttable) = scene_pair(name)
    geom = tgeom.build_geometry(tm, tidx)
    lights = tlight_arrays([rect_light_port()]) if nee else None
    res, rstatic = tb.build_fused_scene(geom, ttable, lights, "cpu")
    clu, cstatic = tb.build_fused_scene(geom, ttable, lights, "cpu", resident_max=0)
    assert not rstatic.clustered and cstatic.clustered
    _step_compare(res, clu, name, nee, f"{name} resident vs clustered")


@pytest.mark.parametrize("name,nee", [("instanced_field", False), ("instanced_field", True),
                                      ("big_mesh_pair", True)])
def test_instanced_walk_matches_flattened_walk(name, nee):
    """The instanced walk (rays in the placements' frames) against the
    flattened walk over the world triangles, under rotations and uniform
    scales. (Under a non-uniform scale the two routes of the JAX package
    shade differently by design: the flattened soup normalises each
    corner normal before interpolating, the instanced pass 2 interpolates
    the unnormalised covectors.)"""
    uniform = dict(instanced_field=dict(stretch=(1.0, 1.0, 1.0)),
                   big_mesh_pair=dict(stretch=False))[name]
    meshes, mats = SCENES[name](TORCH, **uniform)
    midx, table = materials(TORCH, meshes, mats)
    lights = tlight_arrays([rect_light_port()]) if nee else None
    inst, istatic = tb.build_fused_scene_instanced(meshes, midx, table, lights, "cpu",
                                                   min_gain=1.5, min_flat=0)
    flat, fstatic = tb.build_fused_scene(tgeom.build_geometry(meshes, midx), table, lights,
                                         "cpu", resident_max=0)
    assert istatic.instanced and fstatic.clustered and not fstatic.instanced
    cam = "instanced_field" if name == "big_mesh_pair" else name
    _step_compare(flat, inst, cam, nee, f"{name} flattened vs instanced")


def rect_light_port():
    """rect_light() on the port's LightDesc."""
    from gatling_tpu_torch.scene.stage import LightDesc

    ref = rect_light()
    return LightDesc(path=ref.path, light_type=ref.light_type, transform=ref.transform,
                     params=dict(ref.params))


def test_walk_chunking_does_not_change_the_result(monkeypatch):
    """The twin's entry and pair chunk sizes change only its pruning: one
    entry and 64 pairs at a time give the same state."""
    from gatling_tpu_torch.ops import bounce_ref

    meshes, mats = SCENES["big_mesh_pair"](TORCH)
    midx, table = materials(TORCH, meshes, mats)
    lights = tlight_arrays([rect_light_port()])
    fs, _ = tb.build_fused_scene_instanced(meshes, midx, table, lights, "cpu",
                                           min_gain=1.5, min_flat=0)
    state, params = _port_wave("instanced_field", True)
    a = state.clone()
    tb.bounce_step(params[0], fs, a, True)
    monkeypatch.setattr(bounce_ref, "WALK_ENTRIES", 1)
    monkeypatch.setattr(bounce_ref, "WALK_PAIRS", 64)
    b = state.clone()
    tb.bounce_step(params[0], fs, b, True)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
