"""The port's media against the JAX package's, on the CPU.

Media come from the MDL front end (OmniGlass's tint, `material_volume`);
here their coefficients are also set on the material rows directly, as
tests/test_volumes.py does. On the CPU the port runs the kernels' plain
twins, held against the JAX kernels in Pallas interpret mode
(tests/test_volumes.py:155-172):

1. one bounce of the resident twin (K1's) against the JAX `bounce_step`
   with `dataclasses.replace(static, volumes=True, scatter=...)` on the
   absorbing slab of tests/test_volumes.py (absorption, and scattering
   with a forward HG bias), at bounce 0 and at bounce 4, where rays
   inside the medium carry the encoded alive row;
2. the walk twin (K2's) on an instanced field of fog and tinted-glass
   spheres: instance tables with NEE in the scatter mode, flattened
   tables in the absorption mode;
3. K4's twin against `shade_step` with `volumes=True` on the anisotropic
   split scene of tests/test_torch_lobes.py, its balls tinted glass;
4. the fused frame of the fog box (examples.cornell_fog, the scatter
   mode) against the wavefront's at stack 1: the gap that sets
   chip_smoke.py's tolerance.

tests/test_torch_media.py holds the rest (the fog box's K1 step with NEE,
the wavefront's medium stack, tests/test_volumes.py's checks, gi's
routing), so that each file stays near a minute on one worker.

Tolerances as tests/test_torch_lobes.py holds the kernels: state rows
12-15 bit-equal and rows 0-11 within rtol 1e-4 / atol 1e-5, each on 99.9 %
of a resident wave's rays and 99.5 % of a walk's.
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
from gatling_tpu.render.integrator import RenderConfig as JConfig
from gatling_tpu.render.lights import build_light_arrays as jlight_arrays
from gatling_tpu.scene.stage import load_scene as jload_scene

from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.scene import examples as ex
from gatling_tpu_torch.scene.stage import load_scene

from test_torch_clustered_bounce import H, W, check, primary_state, uniforms
from test_torch_clustered_scene import JAX, instanced_field
from test_torch_lobes import aniso_scene, port_tables, slab_light
from test_torch_split_bounce import _agree, shade_twin
from test_volumes import _slab_scene

MIN_AGREE_RESIDENT, MIN_AGREE_WALK = 0.999, 0.995
SLAB_CAMERA = ((0.37, 0.11, 5.0), (0.1, 0.05, -1.0), 0.6)
FOG_BOX_CAMERA = ((0.0, -6.8, 0.0), (0.0, 1.0, 0.0), 0.4)
# the fog box's fused frame against the wavefront's (mediumStackSize 1):
# per-channel means within this share (chip_smoke.py FOG_MEAN_TOL holds the
# full frame to half of it)
FOG_GAP_TOL = 0.01
# the tinted short block, rough: near-specular GGX sampling turns XLA's
# contracted multiply-adds into 1e-4 of a direction (tests/test_torch_lobes.py)
ROUGH_GLASS = dict(transmission=1.0, ior=1.5, roughness=0.25, thin_walled=0,
                   volume_absorption=(0.6, 0.2, 0.05))
FOG = dict(transmission=1.0, ior=1.0, roughness=0.0, thin_walled=0,
           volume_absorption=(0.05, 0.05, 0.05), volume_scattering=(1.5, 1.5, 1.5))


@pytest.fixture(scope="module")
def fog_box(tmp_path_factory):
    """examples.cornell_fog written into a temporary directory."""
    return ex.cornell_fog(str(tmp_path_factory.mktemp("fog_box")))


def fog_box_jax(path: str):
    """JAX geometry, table and lights of the fog box: the tall block the
    MDL fog, the short block rough tinted glass, the bench's rect light."""
    desc = jload_scene(path)
    paths = sorted({m.material for m in desc.meshes if m.material} | {"/glass"})
    for m in desc.meshes:
        if m.path.endswith("/ShortBlock"):
            m.material = "/glass"
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    rows = []
    for p in midx:
        row = jmat.lower_material(desc.materials.get(p) if p else None)
        if p == "/glass":
            row.params.update(ROUGH_GLASS)
        rows.append(row)
    return (jgeom.build_geometry(desc.meshes, midx), jmat.build_material_table(rows),
            jlight_arrays(desc.lights))


def scatter_slab():
    """tests/test_volumes.py's slab with scattering and a forward HG bias."""
    geom, table = _slab_scene((0.5, 1.0, 2.0))
    return geom, jmat._pack_material_table(table._replace(
        volume_scattering=table.volume_scattering.at[0].set(jnp.asarray([1.0, 1.5, 0.7])),
        volume_bias=table.volume_bias.at[0].set(0.3)))


def _steps(scene, static, uni, nee, bounces, seed=5):
    """For each of `bounces`: the params, the state going in (a camera wave
    stepped by the JAX kernel) and the JAX kernel's output."""
    cfg = JConfig(width=W, height=H, has_dome=False, nee=nee)
    state = primary_state(uni, seed=seed)
    steps = {}
    # each interpreted kernel finishes before the next dispatch
    with pltpu.force_tpu_interpret_mode():
        for b in range(max(bounces) + 1):
            params = jpb.make_params(cfg, uni, jnp.int32(b))
            out = jax.block_until_ready(jpb.bounce_step(params, scene, state, static=static,
                                                        nee=nee))
            if b in bounces:
                steps[b] = (np.asarray(params), np.asarray(state), np.asarray(out))
            state = out
    return steps


def _twin_step(scene, static, step, nee, min_agree, label):
    params, state_in, ref = step
    fs = port_tables(scene, static)._replace(
        volumes=tb.VOL_SCATTER if static.scatter else tb.VOL_ABSORB)
    st = tb.state_from_numpy(state_in, "cpu")
    tb.bounce_step(torch.tensor(params), fs, st, nee)
    got = tb.state_to_numpy(st)
    check(ref, got, label, min_agree)
    return got


# ---------------------------------------------------------------------------
# 1. the resident bounce (K1's twin)
# ---------------------------------------------------------------------------

RESIDENT = ("slab", "slab_scatter")


@functools.lru_cache(maxsize=None)
def resident_case(name: str, fog_path: str = ""):
    if name.startswith("slab"):
        geom, table = scatter_slab() if name == "slab_scatter" else _slab_scene()
        lights, (pos, fwd, vfov), nee = None, SLAB_CAMERA, False
    else:
        geom, table, lights = fog_box_jax(fog_path)
        (pos, fwd, vfov), nee = FOG_BOX_CAMERA, True
    scene, static = jpb.build_fused_scene(geom, table, lights)
    assert not static.clustered
    static = dataclasses.replace(static, volumes=True, scatter=name.endswith("scatter"))
    return scene, static, _steps(scene, static, uniforms(pos, fwd, vfov), nee, (0, 4)), nee


def check_resident_case(name: str, bounce: int, fog_path: str = "") -> None:
    scene, static, steps, nee = resident_case(name, fog_path)
    got = _twin_step(scene, static, steps[bounce], nee, MIN_AGREE_RESIDENT,
                     f"{name} bounce {bounce}")
    alive_in = steps[bounce][1].reshape(16, -1)[13]
    assert (alive_in > 0.5).sum() > 100  # the bounce did work
    if bounce == 0:  # rays enter the media
        assert (got.reshape(16, -1)[13] > 1.5).sum() > 20
    elif static.scatter:  # rays came in inside media, with walk steps counted
        assert (alive_in >= 66.0).sum() > 20


@pytest.mark.parametrize("name", RESIDENT)
@pytest.mark.parametrize("bounce", [0, 4])
def test_resident_volume_twin_matches_jax(name, bounce):
    check_resident_case(name, bounce)


# ---------------------------------------------------------------------------
# 2. the walk (K2's twin), instanced and flattened
# ---------------------------------------------------------------------------

def volume_field():
    """tests/test_torch_clustered_scene.py's instanced field: two fog
    spheres, two rough tinted-glass spheres, a diffuse ground."""
    meshes, _mats = instanced_field(JAX, stretch=(1.0, 1.0, 1.0))
    midx = {"/m0": 0, "/m1": 1, "/mg": 2, None: 3}
    over = {"/m0": dict(FOG, roughness=0.2), "/m1": ROUGH_GLASS,
            "/mg": dict(base_color=(0.7, 0.7, 0.7), roughness=0.9)}
    rows = []
    for p in midx:
        row = jmat.lower_material(None)
        row.params.update(over.get(p, {}))
        rows.append(row)
    return meshes, midx, jmat.build_material_table(rows)


WALKS = {"instanced_nee_scatter": (True, True, True), "flattened_absorb": (False, False, False)}


@functools.lru_cache(maxsize=None)
def walk_case(label: str):
    instanced, nee, scatter = WALKS[label]
    meshes, midx, table = volume_field()
    lights = jlight_arrays([slab_light(JAX)]) if nee else None
    if instanced:
        scene, static = jpb.build_fused_scene_instanced(meshes, midx, table, lights,
                                                        min_gain=1.5, min_flat=0)
    else:
        scene, static = jpb.build_fused_scene(jgeom.build_geometry(meshes, midx), table, lights,
                                              resident_max=0)
    assert static.clustered and static.instanced == instanced
    static = dataclasses.replace(static, volumes=True, scatter=scatter)
    uni = uniforms((-1.5, -4.0, 4.0), (0.2, 0.4, -0.6))
    return scene, static, _steps(scene, static, uni, nee, (0, 4)), nee


@pytest.mark.parametrize("label", sorted(WALKS))
@pytest.mark.parametrize("bounce", [0, 4])
def test_walk_volume_twin_matches_jax(label, bounce):
    scene, static, steps, nee = walk_case(label)
    _twin_step(scene, static, steps[bounce], nee, MIN_AGREE_WALK, f"{label} bounce {bounce}")
    assert (steps[bounce][1].reshape(16, -1)[13] > 0.5).sum() > 30


# ---------------------------------------------------------------------------
# 3. the split shade (K4's twin), absorption only
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def split_case():
    meshes, midx, table, room_lights = aniso_scene(JAX)
    rows = []
    for p in midx:  # the balls: rough anisotropic tinted glass
        row = jmat.lower_material(None)
        row.params.update(dict(ROUGH_GLASS, anisotropy=0.5) if p == "/b" else
                          dict(base_color=(0.6, 0.5, 0.4), roughness=0.4, anisotropy=0.3))
        rows.append(row)
    table = jmat.build_material_table(rows)
    scene, static = jpb.build_fused_scene_instanced(meshes, midx, table,
                                                    jlight_arrays(room_lights), min_gain=1.5,
                                                    min_flat=0)
    assert static.instanced and static.tangents
    static = dataclasses.replace(static, textured=True, textured_params=(), volumes=True)
    pool = jtex.empty_pool()
    uni = uniforms((0.2, -2.6, 0.6), (0.0, 1.0, -0.45))
    cfg = JConfig(width=W, height=H, has_dome=False, nee=True)
    state = primary_state(uni, seed=7)
    steps = {}
    with pltpu.force_tpu_interpret_mode():
        for b in range(3):
            params = jpb.make_params(cfg, uni, jnp.int32(b))
            hit = jax.block_until_ready(jpb.trace_step(params, scene, state, static=static))
            parbuf, hit_n = jmaterial_rows(table, pool, hit, ())
            out = jax.block_until_ready(jpb.shade_step(params, scene, state, hit_n, parbuf,
                                                       static=static, nee=True))
            if b in (0, 2):
                steps[b] = tuple(np.asarray(x) for x in (params, state, hit_n, parbuf, out))
            state = out
    return scene, static, steps


@pytest.mark.parametrize("bounce", [0, 2])
def test_split_volume_twin_matches_jax(bounce):
    """On instance tables, K4's walk instance (the resident one shares its
    shading code)."""
    scene, static, steps = split_case()
    params, state_in, hit_n, par, out_ref = steps[bounce]
    fs = port_tables(scene, static)._replace(volumes=tb.VOL_ABSORB)
    st = tb.state_from_numpy(state_in, "cpu")
    shade_twin(torch.tensor(params), fs, st, torch.tensor(hit_n.reshape(hit_n.shape[0], -1)),
               torch.tensor(par.reshape(par.shape[0], -1)), (), True)
    alive = state_in.reshape(16, -1)[13]
    _agree(tb.state_to_numpy(st), out_ref, np.ones_like(alive, bool), MIN_AGREE_WALK,
           f"instanced shade bounce {bounce}", exact_rows=(12, 13, 14, 15),
           close_rows=slice(0, 12))
    assert (alive > 0.5).sum() > 300
    if bounce == 2:
        assert (alive > 1.5).sum() > 5  # some rays inside the glass


# ---------------------------------------------------------------------------
# 4. the fused fog frame against the wavefront's
# ---------------------------------------------------------------------------

def _gi_fog(path, route: str, res: int, spp: int, stack: int = 1):
    desc = load_scene(path)
    scene = gi.create_scene("cpu")
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    binds = [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(res, res, 4))]
    if route == "wavefront":  # an AOV outside FUSED_AOV_MASK: gi's own rule
        binds.append(gi.GiAovBinding(AovId.OBJECT_ID, gi.GiRenderBuffer(res, res, 1, True),
                                     clear_value=-1))
    gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(), aov_bindings=binds,
                                render_settings=dict(spp=spp, maxBounces=8,
                                                     nextEventEstimation=True,
                                                     mediumStackSize=stack,
                                                     maxVolumeWalkLength=7)))
    return scene, binds[0].render_buffer.data[..., :3]


def test_fused_fog_matches_wavefront_in_distribution(fog_box):
    """The fog box at 64x64, 16 spp, 8 bounces, NEE, mediumStackSize 1: the
    scatter mode's frame and the wavefront's per-channel means within
    FOG_GAP_TOL (0.24-0.33 % measured; 0.01-0.08 % at 128x128)."""
    fused_scene, fused = _gi_fog(fog_box, "fused", 64, 16)
    wave_scene, wave = _gi_fog(fog_box, "wavefront", 64, 16)
    assert fused_scene._fused_static.scatter and wave_scene._fused is None
    gap = np.abs(fused.reshape(-1, 3).mean(0) / wave.reshape(-1, 3).mean(0) - 1.0)
    print(f"fog box fused against wavefront: per-channel mean gap {gap}")
    assert np.isfinite(fused).all() and (gap < FOG_GAP_TOL).all(), gap


